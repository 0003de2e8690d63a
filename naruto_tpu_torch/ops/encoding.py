"""Multi-resolution hash-grid encoding, vertex, cell and hybrid layouts
(counterpart of naruto_tpu/ops/encoding.py).

The table is a plain tensor [total_entries, F] in the "vertex" layout (one
row per grid vertex: tcnn's layout, configs/parity.yaml), [total_entries,
8F] in the "cell" layout (one row per grid cell holding its 8 corner
features) or, in the "hybrid" layout, a dict {"hash": [hashed rows, 8F],
"dense": [per dense level, a z-major (R+1, R+1, R+1, F) vertex grid]} whose
dense levels' cell rows are derived from the vertex grids on every
evaluation.

``hash_encode`` is a ``torch.autograd.Function``: the forward gathers the
rows of every (point, level) (the ``gather_rows`` kernel of
``ops/primitives.py`` on the card: one wide row per cell, or eight narrow
vertex rows) and blends the 8 corners; the table's gradient is a sort-based
segment sum of ``ops/segment.py`` (the hand-written kernels of
``ops/kernels.py`` and ``ops/primitives.py``), never a scatter. The
gradient with respect to the points (the pose's, when poses are optimised)
is the product rule over the corner weights, on the features gathered
again; each of the two runs only where an input asks for it.

``vertex_query_inputs`` writes the SDF decoder's whole input, the hash
features and the one-blob, for a query that asks no gradient: on a card in
one launch of ``csrc/query_inputs.cu`` (vertex layout, float32 gathers),
bit for bit its plain version, the encode and the one-blob concatenated.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from naruto_tpu_torch.ops import device_const, kernels, primitives
from naruto_tpu_torch.ops.one_blob import one_blob_encode

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
    layout: str = "vertex"             # "vertex" | "cell" | "hybrid"
    hybrid_dense_slack: float = 1.25
    sort_carry: str = "frac"           # cell rows' backward: "frac" | "weights"

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


def init_hash_table(spec: HashGridSpec, generator: torch.Generator,
                    device="cpu"):
    """tcnn-style init, uniform in [-1e-4, 1e-4], in the layout's structure."""
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


def _level_slots(cx, cy, cz, stride: torch.Tensor,
                 spec: HashGridSpec) -> torch.Tensor:
    """Flat table rows of integer grid coordinates (int64, levels on dim 1):
    dense levels index x + y*stride + z*stride^2, hashed levels take the
    instant-ngp hash, in int64 with 32-bit wrap-around; plus each level's
    offset. `stride` broadcasts against the coordinates."""
    dev = cx.device
    shape = (1, spec.n_levels) + (1,) * (cx.dim() - 2)
    dense_idx = cx + cy * stride + cz * stride * stride
    h = ((cx * _PRIMES[0]) & _U32) ^ ((cy * _PRIMES[1]) & _U32) \
        ^ ((cz * _PRIMES[2]) & _U32)
    hash_idx = h & (spec.table_size - 1)
    dense = device_const(spec.dense_mask, torch.bool, dev).reshape(shape)
    offsets = device_const(spec.level_offsets[:-1], torch.int64,
                           dev).reshape(shape)
    return torch.where(dense, dense_idx, hash_idx) + offsets


def _cell_indices(x: torch.Tensor, spec: HashGridSpec):
    """Cell rows: flat table row per (point, level) -> (idx [N, L] int64,
    w [N, L, 8] f32)."""
    i0, frac = _cell_pos(x, spec)
    s = device_const(spec.resolutions, torch.int64, x.device)[None, :]
    idx = _level_slots(i0[..., 0], i0[..., 1], i0[..., 2], s, spec)
    return idx, _corner_weights(frac)


def _corner_indices(x: torch.Tensor, spec: HashGridSpec):
    """Vertex rows: the 8 corner vertices of every (point, level) ->
    (idx [N, L*8] int32 in corner order, as the JAX function gives them,
    w [N, L, 8] f32). Dense levels index x + y(R+1) + z(R+1)^2; the hash
    runs in int64 and the rows are cast once, here: both gathers of them
    and the backward's sort read 4-byte indices."""
    n = x.shape[0]
    i0, frac = _cell_pos(x, spec)
    dev = x.device
    corners = device_const(_CORNERS, torch.int64, dev)               # [8, 3]
    cx, cy, cz = (i0[..., a, None] + corners[:, a] for a in range(3))
    s = device_const(spec.resolutions, torch.int64, dev)[None, :, None] + 1
    idx = _level_slots(cx, cy, cz, s, spec).to(torch.int32)       # [N, L, 8]
    return idx.reshape(n, spec.n_levels * 8), _corner_weights(frac)


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
    """-> (embedding [N, L*F] f32, the gathered rows' indices: [N, L] for
    cell rows, [N, L*8] for vertex rows)."""
    n = x.shape[0]
    idx, w = (_cell_indices if spec.cell_rows else _corner_indices)(x, spec)
    rows = primitives.gather_rows(_gather_table(table, spec),
                                  idx.reshape(-1))
    rows = rows.reshape(n, spec.n_levels, 8, spec.n_features)
    return _blend(rows, w), idx


def encode_grads_from_gembed(spec: HashGridSpec, x: torch.Tensor,
                             idx: torch.Tensor, g: torch.Tensor):
    """Table cotangent (in the table's structure) from the embedding
    cotangent g [N, L*F]. Cell rows: the segment sum of outer(corner
    weights, level cotangent) over the table's cell rows, the weights
    carried through the sort as one packed-frac column ("frac") or as 8
    bf16 weights ("weights"). Vertex rows: the segment sum of the
    bf16-rounded updates g * w over the vertex rows."""
    from naruto_tpu_torch.ops import segment

    g = g.contiguous()
    _, frac = _cell_pos(x, spec)
    if not spec.cell_rows:
        n, L, F = x.shape[0], spec.n_levels, spec.n_features
        upd = g.reshape(n, L, 1, F) * _corner_weights(frac)[..., None]
        return segment.dense_segment_sum(idx.reshape(-1), upd.reshape(-1, F),
                                         spec.total_entries)
    if spec.sort_carry == "frac":
        d_full = segment.dense_segment_sum_outer_level_major_frac(
            idx, frac, g, spec.total_entries)
    else:
        d_full = segment.dense_segment_sum_outer_level_major(
            idx, _corner_weights(frac), g, spec.total_entries)
    if spec.layout == "hybrid":
        return split_table_grads(d_full, spec)
    return d_full


def position_grads(spec: HashGridSpec, table, x: torch.Tensor,
                   idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """d embedding / d x contracted with g [N, L*F] -> [N, 3]: the product
    rule over each corner weight's three factors, times the level's
    resolution (frac = x * R - i0; the clamps pass no gradient). The
    corner features are gathered again at full precision: the f32-derived
    rows in the hybrid layout, the table itself in the others."""
    n, L, F = x.shape[0], spec.n_levels, spec.n_features
    flat = (derived_gather_table(table, spec, torch.float32)
            if spec.layout == "hybrid" else table)
    feats = primitives.gather_rows(flat, idx.reshape(-1)).reshape(n, L, 8, F)
    _, frac = _cell_pos(x, spec)
    sel = device_const(_CORNERS, torch.bool, x.device)               # [8, 3]
    t = torch.where(sel[None, None], frac[:, :, None, :],
                    1.0 - frac[:, :, None, :])                # [N, L, 8, 3]
    sign = torch.where(sel, 1.0, -1.0)
    p = torch.stack([t[..., 1] * t[..., 2], t[..., 0] * t[..., 2],
                     t[..., 0] * t[..., 1]], dim=-1) * sign
    gdotf = torch.sum(g.reshape(n, L, 1, F) * feats, dim=-1)  # [N, L, 8]
    res = device_const(spec.resolutions, torch.float32, x.device)
    return torch.einsum("nlc,nlca,l->na", gdotf, p, res)


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, *leaves):
        out, idx = _encode_impl(_table_from_leaves(leaves, spec), x, spec)
        ctx.spec = spec
        ctx.save_for_backward(x, idx, *leaves)
        return out

    @staticmethod
    def backward(ctx, g):
        x, idx, *leaves = ctx.saved_tensors
        spec = ctx.spec
        d_leaves = [None] * len(leaves)
        if any(ctx.needs_input_grad[2:]):
            d = encode_grads_from_gembed(spec, x, idx, g)
            d_leaves = [t.to(leaf.dtype) for t, leaf in
                        zip(table_leaves(d), leaves)]
        d_x = (position_grads(spec, _table_from_leaves(leaves, spec), x,
                              idx, g) if ctx.needs_input_grad[0] else None)
        return (d_x, None, *d_leaves)


def hash_encode(table, x: torch.Tensor, spec: HashGridSpec) -> torch.Tensor:
    """Encode points x [N, 3] in [0, 1] -> [N, L*F] f32 features;
    differentiable in the table and in x."""
    return _HashEncode.apply(x, spec, *table_leaves(table))


def query_inputs_refusal(table, x: torch.Tensor, spec: HashGridSpec,
                         n_bins: int) -> str:
    """Why ``csrc/query_inputs.cu`` cannot write the decoder input of this
    query ('' where it can): it takes the vertex layout with float32
    gathers, 2 features a level (tcnn's), an even count of at most 32
    levels and a multiple of 4 bins (whole 16-byte stores), float32
    points, and no gradient through the table or the points."""
    if spec.layout != "vertex":
        return f"the {spec.layout} layout"
    if spec.gather_dtype != "float32":
        return f"{spec.gather_dtype} gathers"
    if spec.n_features != 2 or spec.n_levels > 32 or spec.n_levels % 2 \
            or n_bins % 4 or n_bins < 4:
        return (f"{spec.n_levels} levels of {spec.n_features} features "
                f"and {n_bins} bins")
    if x.dtype != torch.float32:
        return f"{x.dtype} points"
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        return "a gradient through the table or the points"
    return ""


def vertex_query_inputs_plain(table, x: torch.Tensor, spec: HashGridSpec,
                              n_bins: int) -> torch.Tensor:
    return torch.cat([hash_encode(table, x, spec),
                      one_blob_encode(x, n_bins)], dim=-1)


@functools.lru_cache(maxsize=None)
def _level_words(spec: HashGridSpec):
    """(R, dense, offset) a level, int32, for the kernel's parameters."""
    words = [w for r, d, off in zip(spec.resolutions, spec.dense_mask,
                                    spec.level_offsets)
             for w in (r, int(d), off)]
    return (ctypes.c_int32 * len(words))(*words)


def vertex_query_inputs(table, x: torch.Tensor, spec: HashGridSpec,
                        n_bins: int) -> torch.Tensor:
    """The SDF decoder's input at x [N, 3] in [0, 1]: [N, L*F + 3*n_bins]
    f32, the hash features, then the one-blob. On the CPU the plain
    version; on a card one launch, bit for bit the plain version there, or
    a ValueError where ``query_inputs_refusal`` names a reason."""
    if not x.is_cuda:
        return vertex_query_inputs_plain(table, x, spec, n_bins)
    why = query_inputs_refusal(table, x, spec, n_bins)
    if why:
        raise ValueError(f"no query_inputs kernel for {why}")
    tbl = _gather_table(table, spec)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {tuple(x.shape)}")
    x = x.contiguous()
    n = x.shape[0]
    if tbl.shape != (spec.total_entries, 2) or not tbl.is_contiguous() \
            or tbl.data_ptr() % 8 or tbl.device != x.device:
        raise ValueError(f"table {tuple(tbl.shape)} must be contiguous, "
                         f"8-byte aligned and on {x.device}")
    out = torch.empty((n, spec.output_dim + 3 * n_bins), dtype=torch.float32,
                      device=x.device)
    if n:
        # one_blob_encode's edges, and torch's division by the host scalar
        # sigma * sqrt(2): a product with its f32 reciprocal
        edges = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32,
                               device=x.device)
        inv = np.float32(1.0) / np.float32(1.0 / n_bins * math.sqrt(2.0))
        words = _level_words(spec)
        kernels.launch(
            "query_inputs",
            kernels.lib("query_inputs").naruto_vertex_query_inputs, x.device,
            x.data_ptr(), tbl.data_ptr(), edges.data_ptr(), out.data_ptr(),
            n, ctypes.addressof(words), spec.n_levels,
            spec.table_size - 1, n_bins, float(inv))
    return out
