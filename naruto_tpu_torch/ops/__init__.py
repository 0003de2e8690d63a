"""Field operators and the hand-written kernels of the hash-grid backward."""
import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """A small constant tensor, copied to `device` once: a fresh copy from
    host memory on every call would stall the card's stream."""
    return torch.tensor(values, dtype=dtype, device=device)


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the rows of a narrow [M, F] tensor, run as a scan
    along the inner dimension of its transpose: torch's scan over an outer
    dimension gives each column one thread on the card, which at F = 8 and
    M ~ 1e5 is milliseconds per call."""
    return torch.cumsum(x.t().contiguous(), dim=1).t().contiguous()


def unit_linspace(n: int) -> np.ndarray:
    """jnp.linspace(0, 1, n) in float32 as XLA computes it: the iota times
    the float32 reciprocal of n - 1, then the endpoint (np.linspace and
    torch.linspace differ from it in the last bit at some points)."""
    if n < 2:
        return np.zeros(n, np.float32)
    step = np.arange(n - 1, dtype=np.float32) * (np.float32(1.0)
                                                 / np.float32(n - 1))
    return np.concatenate([step, np.ones(1, np.float32)])
