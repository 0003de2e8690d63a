"""Trilinear sampling of 3D voxel grids (counterpart of
naruto_tpu/ops/grid_sample.py).

align_corners=False maps a normalized coordinate g in [-1, 1] to voxel
coordinate ((g+1)*size - 1)/2 (the learnable uncertainty grid);
align_corners=True maps it to (g+1)/2*(size-1). Out-of-range coordinates are
clamped to the border (torch's grid_sample pads with zeros instead; the
points here lie inside the AABB, so only the half-voxel fringe differs).

The sample and its volume gradient read and write the [X, Y, Z] grid
itself, so their cost grows with the samples, not with the grid:
``trilerp_forward`` gathers each sample's 8 corners from the grid, and
``trilerp_vjp`` adds the per-cell sums into the vertices of the cells the
samples touched. The per-cell sums are sort-based as in the JAX package:
the cells' keys are sorted, and ``primitives.sorted_segment_sum``, fed the
sort permutation and keyed by each run's rank, sums each touched cell's
weighted cotangent rows in a fixed order on either device into a row of
its own ([N, 8], N the samples). Each wrapper is one kernel of
``csrc/trilerp.cu`` on a card, counted in ``kernels.LAUNCHES``, and its
plain version here on the CPU.
"""
from __future__ import annotations

import torch

from naruto_tpu_torch.ops import device_const, primitives
from naruto_tpu_torch.ops.kernels import launch, lib

_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                 for dz in (0, 1))
_INT32_MAX = 2 ** 31 - 1


def _corner_sel(coords: torch.Tensor) -> torch.Tensor:
    return device_const(_CORNERS, torch.bool, coords.device)   # [8, 3]


def _offsets(shape) -> tuple:
    """Each corner's offset in the flattened grid, in _CORNERS order."""
    _, Y, Z = shape
    return tuple(dx * Y * Z + dy * Z + dz for dx, dy, dz in _CORNERS)


def _corner_data(shape, coords: torch.Tensor):
    """coords [N, 3] voxel units -> (key [N] int32: the flat grid index of
    the first corner of each sample's cell, weights [N, 8], frac [N, 3])."""
    X, Y, Z = shape
    limit = device_const((X - 1.0, Y - 1.0, Z - 1.0), coords.dtype,
                         coords.device)
    c = torch.minimum(torch.clamp(coords, min=0.0), limit)
    i0 = torch.minimum(torch.clamp(torch.floor(c).long(), min=0),
                       device_const((X - 2, Y - 2, Z - 2), torch.int64,
                                    coords.device))
    frac = c - i0.to(coords.dtype)
    key = (i0[:, 0] * (Y * Z) + i0[:, 1] * Z + i0[:, 2]).to(torch.int32)
    t = torch.where(_corner_sel(coords)[None], frac[:, None, :],
                    1.0 - frac[:, None, :])
    w = t[..., 0] * t[..., 1] * t[..., 2]           # fixed product order
    return key, w, frac


def _check_grid(shape) -> None:
    if len(shape) != 3 or min(shape) < 2 or \
            shape[0] * shape[1] * shape[2] > _INT32_MAX:
        raise ValueError(f"grid {tuple(shape)} must be [X, Y, Z], each at "
                         f"least 2, of at most 2^31 - 1 voxels")


def _check(dtypes, tensors, shapes) -> torch.device:
    """Each tensor of its dtype and its shape (None: any size there), all
    contiguous and on one device."""
    for t, dtype, shape in zip(tensors, dtypes, shapes):
        if t.dtype != dtype:
            raise TypeError(f"trilerp takes {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or any(
                s is not None and s != n for s, n in zip(shape, t.shape)):
            raise ValueError(f"shape {tuple(t.shape)} is not {shape}")
    primitives._contiguous(*tensors)
    return primitives._device(*tensors)


def trilerp_forward_plain(vol: torch.Tensor, coords: torch.Tensor):
    key, w, frac = _corner_data(vol.shape, coords)
    idx = key[:, None].long() + device_const(_offsets(vol.shape),
                                             torch.int64, vol.device)
    return key, w, frac, torch.take(vol, idx)


def trilerp_forward(vol: torch.Tensor, coords: torch.Tensor):
    """vol [X, Y, Z] f32, coords [N, 3] f32 in voxel units -> (key [N]
    int32, weights [N, 8], frac [N, 3], vals [N, 8]): each sample's cell
    (the flat index of its first corner), its corner weights and place in
    the cell, and the grid's values at the cell's corners, in _CORNERS
    order. One launch of csrc/trilerp.cu on a card, bit for bit the plain
    version there."""
    dev = _check((torch.float32, torch.float32), (vol, coords),
                 ((None, None, None), (None, 3)))
    _check_grid(vol.shape)
    if not vol.is_cuda:
        return trilerp_forward_plain(vol, coords)
    n = coords.shape[0]
    key = torch.empty(n, dtype=torch.int32, device=dev)
    w = torch.empty((n, 8), dtype=torch.float32, device=dev)
    frac = torch.empty((n, 3), dtype=torch.float32, device=dev)
    vals = torch.empty((n, 8), dtype=torch.float32, device=dev)
    if n:
        launch("trilerp_forward", lib("trilerp").naruto_trilerp_forward, dev,
               vol.data_ptr(), coords.data_ptr(), n, *vol.shape,
               key.data_ptr(), w.data_ptr(), frac.data_ptr(), vals.data_ptr())
    return key, w, frac, vals


def trilerp_vjp_plain(shape, si: torch.Tensor, rank: torch.Tensor,
                      d_cell: torch.Tensor) -> torch.Tensor:
    """The kernel's vertex sums in torch: every (row, corner) of a run's
    first row sums, in corner order, the touched neighbouring cells' rows
    of its vertex, and the first such cell's row writes the vertex."""
    X, Y, Z = shape
    n = si.shape[0]
    d_vol = d_cell.new_zeros(X * Y * Z)
    if n:
        dev = si.device
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = si[1:] != si[:-1]
        keys = si.long()
        v = keys[:, None] + device_const(_offsets(shape), torch.int64, dev)
        vc = torch.stack([v // (Y * Z), v // Z % Y, v % Z], dim=-1)
        top = device_const((X - 2, Y - 2, Z - 2), torch.int64, dev)
        corner = torch.arange(8, device=dev)
        s = d_cell.new_zeros((n, 8))
        writer = first[:, None].expand(n, 8).clone()
        for j, (off, d) in enumerate(zip(_offsets(shape), _CORNERS)):
            cc = vc - device_const(d, torch.int64, dev)
            c = v - off
            at = torch.searchsorted(keys, c).clamp(max=n - 1)
            hit = ((cc >= 0) & (cc <= top)).all(dim=-1) & (keys[at] == c)
            s = torch.where(hit, s + d_cell[rank[at].long(), j], s)
            writer &= ~hit | (corner <= j)
        d_vol[v[writer]] = s[writer]
    return d_vol.view(X, Y, Z)


def trilerp_vjp(shape, si: torch.Tensor, rank: torch.Tensor,
                d_cell: torch.Tensor) -> torch.Tensor:
    """The grid gradient [X, Y, Z] f32 from the sorted cell keys si [N]
    int32 (trilerp_forward's), each row's run rank [N] int32 and d_cell
    [N, 8] f32 (row r: the summed weighted cotangent of run r's cell):
    vertex v of a touched cell holds ((0 + a_0) + ...) + a_7 over its
    neighbouring cells the samples touched, a_j the row of the cell whose
    corner j is v; every other vertex 0. On a card a zero fill and one
    launch of csrc/trilerp.cu (no atomics: bit for bit the plain
    version)."""
    shape = tuple(shape)
    _check_grid(shape)
    dev = _check((torch.int32, torch.int32, torch.float32),
                 (si, rank, d_cell), ((None,), (si.shape[0],),
                                      (si.shape[0], 8)))
    if not si.is_cuda:
        return trilerp_vjp_plain(shape, si, rank, d_cell)
    d_vol = torch.zeros(shape, dtype=torch.float32, device=dev)
    n = si.shape[0]
    if n:
        launch("trilerp_vjp", lib("trilerp").naruto_trilerp_vjp, dev,
               si.data_ptr(), rank.data_ptr(), d_cell.data_ptr(), n, *shape,
               d_vol.data_ptr())
    return d_vol


def run_ranks(si: torch.Tensor) -> torch.Tensor:
    """Each row's run rank [N] int32 in the sorted keys si [N] (0 for the
    first run's rows), without reading the count of runs on the host."""
    n = si.shape[0]
    rank = torch.zeros(n, dtype=torch.int32, device=si.device)
    if n > 1:
        torch.cumsum(si[1:] != si[:-1], 0, dtype=torch.int32, out=rank[1:])
    return rank


def _vol_grad(shape, key: torch.Tensor, gw: torch.Tensor) -> torch.Tensor:
    """d_vol from the cell keys [N] and the weighted cotangent rows [N,
    8]: the stable sort of the keys, the per-cell sums keyed by run rank
    (N rows, not a row a cell of the grid), the vertex sums."""
    si, perm = torch.sort(key, stable=True)
    rank = run_ranks(si)
    d_cell = primitives.sorted_segment_sum(rank, gw, si.shape[0],
                                           round_bf16=False, perm=perm)
    return trilerp_vjp(shape, si, rank, d_cell)


class _Trilerp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, coords):
        key, w, frac, vals = trilerp_forward(vol, coords)
        ctx.save_for_backward(key, w, frac, vals)
        ctx.vol_shape = tuple(vol.shape)
        return torch.sum(vals * w, dim=-1)

    @staticmethod
    def backward(ctx, g):
        key, w, frac, vals = ctx.saved_tensors
        d_vol = d_coords = None
        if ctx.needs_input_grad[0]:
            d_vol = _vol_grad(ctx.vol_shape, key, g[:, None] * w)
        if ctx.needs_input_grad[1]:
            sel = _corner_sel(frac)
            t = torch.where(sel[None], frac[:, None, :],
                            1.0 - frac[:, None, :])            # [N, 8, 3]
            sign = torch.where(sel, 1.0, -1.0).to(frac.dtype)  # [8, 3]
            p = torch.stack([t[..., 1] * t[..., 2], t[..., 0] * t[..., 2],
                             t[..., 0] * t[..., 1]], dim=-1)   # [N, 8, 3]
            d_coords = torch.einsum("n,nc,ca,nca->na", g, vals, sign, p)
        return d_vol, d_coords


def _trilerp(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    return _Trilerp.apply(vol, coords)


def trilinear_sample(vol: torch.Tensor, pts01: torch.Tensor,
                     align_corners: bool = False) -> torch.Tensor:
    """Sample vol [X, Y, Z] at normalized points pts01 [N, 3] in [0, 1]^3."""
    shape = device_const(tuple(vol.shape), pts01.dtype, pts01.device)
    g = pts01 * 2.0 - 1.0
    if align_corners:
        coords = (g + 1.0) / 2.0 * (shape - 1.0)
    else:
        coords = ((g + 1.0) * shape - 1.0) / 2.0
    return _trilerp(vol, coords)
