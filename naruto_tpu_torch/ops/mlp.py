"""Tiny bias-free MLPs (counterpart of naruto_tpu/ops/mlp.py).

Weights are kept as [in, out] matrices applied as ``x @ W`` so parameters
cross between the two packages unchanged. The reference parity path is
full fp32: ``Mapper`` turns TF32 off for matmuls and convolutions.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def init_mlp_params(dims: Sequence[int], generator: torch.Generator,
                    device="cpu") -> List[torch.Tensor]:
    """dims [in, hidden..., out] -> weights [in, out], each
    U(-1/sqrt(in), 1/sqrt(in)) like torch's Linear init."""
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        bound = 1.0 / d_in ** 0.5
        w = torch.rand((d_in, d_out), generator=generator, device=device)
        params.append(w * (2 * bound) - bound)
    return params


def mlp_apply(params: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """ReLU between layers, linear output."""
    h = x
    for i, w in enumerate(params):
        h = h @ w
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def use_full_fp32_matmul() -> None:
    """fp32 matmuls and convolutions in full precision on the card (cuDNN
    convolutions default to TF32, which keeps about three digits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
