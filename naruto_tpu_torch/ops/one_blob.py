"""One-blob positional encoding (counterpart of naruto_tpu/ops/one_blob.py).

Each input dimension x in [0, 1] becomes the integral of a Gaussian
(sigma = 1/n_bins) centred at x over each of n_bins equal bins:
  f_i = Phi((e_{i+1} - x)/sigma) - Phi((e_i - x)/sigma).
``torch.special.erf`` and ``jax.lax.erf`` may differ in the last ulp.
"""
from __future__ import annotations

import math

import torch


def one_blob_encode(x: torch.Tensor, n_bins: int = 16) -> torch.Tensor:
    """x: [..., D] in [0, 1] -> [..., D*n_bins]."""
    edges = torch.linspace(0.0, 1.0, n_bins + 1, dtype=x.dtype,
                           device=x.device)
    sigma = 1.0 / n_bins
    z = (edges - x[..., None]) / (sigma * math.sqrt(2.0))
    cdf = 0.5 * (1.0 + torch.special.erf(z))
    feats = cdf[..., 1:] - cdf[..., :-1]
    return feats.reshape(*x.shape[:-1], x.shape[-1] * n_bins)
