"""Multi-resolution hash-grid encoding, cell and hybrid layouts
(counterpart of naruto_tpu/ops/encoding.py).

The table is a plain tensor [total_entries, 8F] in the "cell" layout (one
row per grid cell holding its 8 corner features) or, in the "hybrid" layout,
a dict {"hash": [hashed rows, 8F], "dense": [per dense level, a z-major
(R+1, R+1, R+1, F) vertex grid]} whose dense levels' cell rows are derived
from the vertex grids on every evaluation.

``hash_encode`` is a ``torch.autograd.Function``: the forward gathers one
wide row per (point, level) (the ``gather_rows`` kernel of
``ops/primitives.py`` on the card) and blends its 8 corners; the backward is the
sort + prefix-scan segment sum of ``ops/segment.py`` (the hand-written
kernels of ``ops/kernels.py``), never a scatter. Position gradients
(needed only when poses are optimised) and the vertex layout are not
ported yet.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from naruto_tpu_torch.ops import device_const, primitives

# instant-ngp hash primes (pi1 = 1 keeps a dense-ish x ordering)
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

# corner c = cx*4 + cy*2 + cz
_CORNERS = tuple((cx, cy, cz) for cx in (0, 1) for cy in (0, 1)
                 for cz in (0, 1))

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class HashGridSpec:
    """Static hash-grid hyperparameters; same fields and derived sizes as
    naruto_tpu.ops.encoding.HashGridSpec."""
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 16
    base_resolution: int = 16
    finest_resolution: int = 256
    gather_dtype: str = "float32"      # dtype of the rows the forward gathers
    layout: str = "vertex"             # "cell" | "hybrid" ("vertex" not ported)
    hybrid_dense_slack: float = 1.25
    sort_carry: str = "frac"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @functools.cached_property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return float(
            np.exp(np.log(self.finest_resolution / self.base_resolution)
                   / (self.n_levels - 1)))

    @functools.cached_property
    def resolutions(self) -> Tuple[int, ...]:
        b = self.per_level_scale
        return tuple(int(np.floor(self.base_resolution * b ** lv + 1e-6))
                     for lv in range(self.n_levels))

    @property
    def cell_rows(self) -> bool:
        return self.layout in ("cell", "hybrid")

    @functools.cached_property
    def dense_mask(self) -> Tuple[bool, ...]:
        if self.layout == "hybrid":
            cap = int(self.table_size * self.hybrid_dense_slack)
            return tuple(r ** 3 <= cap for r in self.resolutions)
        if self.cell_rows:
            return tuple(r ** 3 <= self.table_size for r in self.resolutions)
        return tuple((r + 1) ** 3 <= self.table_size
                     for r in self.resolutions)

    @functools.cached_property
    def level_sizes(self) -> Tuple[int, ...]:
        sizes = []
        for res, d in zip(self.resolutions, self.dense_mask):
            dense = res ** 3 if self.cell_rows else (res + 1) ** 3
            sizes.append(dense if d else self.table_size)
        return tuple(sizes)

    @property
    def hybrid_hash_rows(self) -> int:
        return sum(s for s, d in zip(self.level_sizes, self.dense_mask)
                   if not d)

    @functools.cached_property
    def level_offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def total_entries(self) -> int:
        return self.level_offsets[-1]

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def row_features(self) -> int:
        return 8 * self.n_features if self.cell_rows else self.n_features

    @classmethod
    def from_bound(cls, bound, voxel_sdf: float = 0.02, **kw) -> "HashGridSpec":
        """Finest resolution from the scene AABB: int(max side / voxel_sdf)."""
        bound = np.asarray(bound)
        max_side = float((bound[:, 1] - bound[:, 0]).max())
        return cls(finest_resolution=max(int(max_side / voxel_sdf), 16), **kw)


def _check_ported(spec: HashGridSpec) -> None:
    if not spec.cell_rows:
        raise NotImplementedError(
            f"hash-grid layout {spec.layout!r} is not ported; use 'hybrid' "
            f"or 'cell'")
    if spec.sort_carry != "frac":
        raise NotImplementedError(
            f"sort_carry {spec.sort_carry!r} is not ported; use 'frac'")


def init_hash_table(spec: HashGridSpec, generator: torch.Generator,
                    device="cpu"):
    """tcnn-style init, uniform in [-1e-4, 1e-4], in the layout's structure."""
    _check_ported(spec)

    def uniform(*shape):
        u = torch.rand(shape, generator=generator, device=device)
        return u * 2e-4 - 1e-4

    if spec.layout != "hybrid":
        return uniform(spec.total_entries, spec.row_features)
    dense = [uniform(res + 1, res + 1, res + 1, spec.n_features)
             for res, d in zip(spec.resolutions, spec.dense_mask) if d]
    return {"hash": uniform(spec.hybrid_hash_rows, spec.row_features),
            "dense": dense}


def table_leaves(table) -> list:
    """The table's tensors in a fixed order: [hash, dense...] or [table]."""
    if isinstance(table, dict):
        return [table["hash"], *table["dense"]]
    return [table]


def _table_from_leaves(leaves, spec: HashGridSpec):
    if spec.layout == "hybrid":
        return {"hash": leaves[0], "dense": list(leaves[1:])}
    return leaves[0]


def derived_cell_rows(grid: torch.Tensor, res: int, dtype) -> torch.Tensor:
    """z-major vertex grid [R+1, R+1, R+1, F] -> cell rows [R^3, 8F] with
    corner c = cx*4 + cy*2 + cz at columns [c*F, (c+1)*F): eight exact
    slices (a one-hot convolution would run in TF32 through cuDNN)."""
    F = grid.shape[-1]
    rows = torch.cat([grid[cz:cz + res, cy:cy + res, cx:cx + res]
                      for cx, cy, cz in _CORNERS], dim=-1)
    return rows.reshape(res ** 3, 8 * F).to(dtype)


def derived_gather_table(table, spec: HashGridSpec, dtype) -> torch.Tensor:
    """Hybrid layout: the full [total_entries, 8F] gather table from the
    dense levels' vertex grids and the hashed levels' cell rows."""
    blocks = []
    di = hoff = 0
    for res, size, d in zip(spec.resolutions, spec.level_sizes,
                            spec.dense_mask):
        if d:
            blocks.append(derived_cell_rows(table["dense"][di], res, dtype))
            di += 1
        else:
            blocks.append(table["hash"][hoff:hoff + size].to(dtype))
            hoff += size
    return torch.cat(blocks, dim=0)


def _cell_rows_transpose(d_rows: torch.Tensor, res: int,
                         n_features: int) -> torch.Tensor:
    """Cotangent of derived cell rows [R^3, 8F] -> vertex grid
    [R+1, R+1, R+1, F]: each corner block adds in at its corner offset,
    in corner order (the same sum order as the JAX sum of pads)."""
    F = n_features
    out = d_rows.new_zeros((res + 1, res + 1, res + 1, F), dtype=torch.float32)
    for c, (cx, cy, cz) in enumerate(_CORNERS):
        blk = d_rows[:, c * F:(c + 1) * F].float().reshape(res, res, res, F)
        out[cz:cz + res, cy:cy + res, cx:cx + res] += blk
    return out


def split_table_grads(d_full: torch.Tensor, spec: HashGridSpec) -> dict:
    """Hybrid layout: split the derived-table cotangent [total, 8F] into
    {"hash": ..., "dense": [...]}."""
    f = spec.n_features
    hash_parts, dense_parts = [], []
    for res, size, off, d in zip(spec.resolutions, spec.level_sizes,
                                 spec.level_offsets[:-1], spec.dense_mask):
        block = d_full[off:off + size]
        if d:
            dense_parts.append(_cell_rows_transpose(block, res, f))
        else:
            hash_parts.append(block.float())
    hash_grad = (torch.cat(hash_parts, dim=0) if hash_parts
                 else d_full.new_zeros((0, 8 * f)))
    return {"hash": hash_grad, "dense": dense_parts}


def _cell_pos(x: torch.Tensor, spec: HashGridSpec):
    """Per-level cell base i0 [N, L, 3] int64 and frac [N, L, 3] f32."""
    res = device_const(spec.resolutions, torch.float32, x.device)
    res_i = device_const(spec.resolutions, torch.int64, x.device)
    pos = x[:, None, :] * res[None, :, None]
    i0 = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0),
                       (res_i - 1)[None, :, None])
    frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
    return i0, frac


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights [N, L, 8] in corner order from frac [N, L, 3]."""
    sel = device_const(_CORNERS, torch.bool, frac.device)           # [8, 3]
    t = torch.where(sel[None, None], frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])
    # a fixed product order: a reduction may associate differently on the
    # card and the host, and a weight one f32 ulp apart can round to
    # another bf16 value in the backward
    return t[..., 0] * t[..., 1] * t[..., 2]


def _cell_indices(x: torch.Tensor, spec: HashGridSpec):
    """Flat table row per (point, level) -> (idx [N, L] int64,
    w [N, L, 8] f32). Hashing runs in int64 with 32-bit wrap-around."""
    i0, frac = _cell_pos(x, spec)
    dev = x.device
    s = device_const(spec.resolutions, torch.int64, dev)[None, :]
    dense_idx = i0[..., 0] + i0[..., 1] * s + i0[..., 2] * s * s
    h = ((i0[..., 0] * _PRIMES[0]) & _U32) \
        ^ ((i0[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((i0[..., 2] * _PRIMES[2]) & _U32)
    hash_idx = h & (spec.table_size - 1)
    dense = device_const(spec.dense_mask, torch.bool, dev)[None, :]
    offsets = device_const(spec.level_offsets[:-1], torch.int64, dev)[None, :]
    idx = torch.where(dense, dense_idx, hash_idx) + offsets
    return idx, _corner_weights(frac)


def _blend(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows [N, L, 8, F] (gather dtype), w [N, L, 8] f32 -> [N, L*F] f32.

    As in the JAX blend: the weights are cast to the gather dtype, each
    weighted corner row is rounded to it, and the 8-corner sum is f32."""
    n = rows.shape[0]
    weighted = rows * w.to(rows.dtype)[..., None]
    return weighted.float().sum(dim=2).reshape(n, -1)


def _gather_table(table, spec: HashGridSpec) -> torch.Tensor:
    dtype = _DTYPES[spec.gather_dtype]
    if spec.layout == "hybrid":
        return derived_gather_table(table, spec, dtype)
    return table.to(dtype)


def _encode_impl(table, x: torch.Tensor, spec: HashGridSpec):
    n = x.shape[0]
    idx, w = _cell_indices(x, spec)
    rows = primitives.gather_rows(_gather_table(table, spec),
                                  idx.reshape(-1))
    rows = rows.reshape(n, spec.n_levels, 8, spec.n_features)
    return _blend(rows, w), idx


def encode_grads_from_gembed(spec: HashGridSpec, x: torch.Tensor,
                             idx: torch.Tensor, g: torch.Tensor):
    """Table cotangent (in the table's structure) from the embedding
    cotangent g [N, L*F]: the frac-carry segment sum of
    outer(corner weights, level cotangent) over the table slots."""
    from naruto_tpu_torch.ops.segment import (
        dense_segment_sum_outer_level_major_frac)

    _, frac = _cell_pos(x, spec)
    d_full = dense_segment_sum_outer_level_major_frac(
        idx, frac, g.contiguous(), spec.total_entries)
    if spec.layout == "hybrid":
        return split_table_grads(d_full, spec)
    return d_full


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, *leaves):
        out, idx = _encode_impl(_table_from_leaves(leaves, spec), x, spec)
        ctx.spec = spec
        ctx.leaf_dtypes = [t.dtype for t in leaves]
        ctx.save_for_backward(x, idx)
        return out

    @staticmethod
    def backward(ctx, g):
        x, idx = ctx.saved_tensors
        d = encode_grads_from_gembed(ctx.spec, x, idx, g)
        return (None, None, *(t.to(dt) for t, dt in
                              zip(table_leaves(d), ctx.leaf_dtypes)))


def hash_encode(table, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode points x [N, 3] in [0, 1] -> [N, L*F] f32 features."""
    _check_ported(spec)
    if x.requires_grad:
        raise NotImplementedError("position gradients of hash_encode are "
                                  "not ported yet (tracking is off)")
    return _HashEncode.apply(x, spec, *table_leaves(table))
