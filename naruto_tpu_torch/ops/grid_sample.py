"""Trilinear sampling of 3D voxel grids (counterpart of
naruto_tpu/ops/grid_sample.py).

align_corners=False maps a normalized coordinate g in [-1, 1] to voxel
coordinate ((g+1)*size - 1)/2 (the learnable uncertainty grid);
align_corners=True maps it to (g+1)/2*(size-1). Out-of-range coordinates are
clamped to the border (torch's grid_sample pads with zeros instead; the
points here lie inside the AABB, so only the half-voxel fringe differs).

The volume gradient is a segment sum over cells, sort-based as in the JAX
package: ``segment.dense_segment_sum`` sorts the cell ids and sums each
cell's run with ``sorted_segment_sum``, which reads the weighted cotangent
rows by the sort permutation itself (no gather), in a fixed order on either
device.
"""
from __future__ import annotations

from typing import Optional

import torch

from naruto_tpu_torch.ops import device_const, primitives

_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
                 for dz in (0, 1))


def _corner_sel(coords: torch.Tensor) -> torch.Tensor:
    return device_const(_CORNERS, torch.bool, coords.device)   # [8, 3]


def _corner_data(shape, coords: torch.Tensor):
    """coords [N, 3] voxel units -> (cell id [N] of the (X-1)(Y-1)(Z-1)
    cell-packed view, weights [N, 8], frac [N, 3])."""
    X, Y, Z = shape
    limit = device_const((X - 1.0, Y - 1.0, Z - 1.0), coords.dtype,
                         coords.device)
    c = torch.minimum(torch.clamp(coords, min=0.0), limit)
    i0 = torch.minimum(torch.clamp(torch.floor(c).long(), min=0),
                       device_const((X - 2, Y - 2, Z - 2), torch.int64,
                                    coords.device))
    frac = c - i0.to(coords.dtype)
    cell = i0[:, 0] * ((Y - 1) * (Z - 1)) + i0[:, 1] * (Z - 1) + i0[:, 2]
    t = torch.where(_corner_sel(coords)[None], frac[:, None, :],
                    1.0 - frac[:, None, :])
    w = t[..., 0] * t[..., 1] * t[..., 2]           # fixed product order
    return cell, w, frac


def cell_pack(vol: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z] -> [(X-1)(Y-1)(Z-1), 8]: the 8 corner values of each cell,
    which every sample of vol gathers from (a caller that samples one
    volume in many batches packs it once)."""
    X, Y, Z = vol.shape
    return torch.stack([vol[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
                        for dx, dy, dz in _CORNERS], dim=-1).reshape(-1, 8)


class _Trilerp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, coords, cells):
        cell, w, frac = _corner_data(vol.shape, coords)
        cells = cell_pack(vol) if cells is None else cells
        vals = primitives.gather_rows(cells, cell)   # [N, 8]
        ctx.save_for_backward(cell, w, frac, vals)
        ctx.vol_shape = tuple(vol.shape)
        return torch.sum(vals * w, dim=-1)

    @staticmethod
    def backward(ctx, g):
        from naruto_tpu_torch.ops.segment import dense_segment_sum

        cell, w, frac, vals = ctx.saved_tensors
        X, Y, Z = ctx.vol_shape
        d_vol = d_coords = None
        if ctx.needs_input_grad[0]:
            n_cells = (X - 1) * (Y - 1) * (Z - 1)
            d_cell = dense_segment_sum(cell, g[:, None] * w, n_cells,
                                       pack_bf16=False)
            d_cell = d_cell.reshape(X - 1, Y - 1, Z - 1, 8)
            # exact transpose of cell_pack: each corner block adds into the
            # vertex grid at its corner offset
            d_vol = g.new_zeros((X, Y, Z))
            for k, (dx, dy, dz) in enumerate(_CORNERS):
                d_vol[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1] += \
                    d_cell[..., k]
        if ctx.needs_input_grad[1]:
            sel = _corner_sel(frac)
            t = torch.where(sel[None], frac[:, None, :],
                            1.0 - frac[:, None, :])            # [N, 8, 3]
            sign = torch.where(sel, 1.0, -1.0).to(frac.dtype)  # [8, 3]
            p = torch.stack([t[..., 1] * t[..., 2], t[..., 0] * t[..., 2],
                             t[..., 0] * t[..., 1]], dim=-1)   # [N, 8, 3]
            d_coords = torch.einsum("n,nc,ca,nca->na", g, vals, sign, p)
        return d_vol, d_coords, None


def _trilerp(vol: torch.Tensor, coords: torch.Tensor,
             cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _Trilerp.apply(vol, coords, cells)


def trilinear_sample(vol: torch.Tensor, pts01: torch.Tensor,
                     align_corners: bool = False,
                     cells: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample vol [X, Y, Z] at normalized points pts01 [N, 3] in [0, 1]^3;
    `cells`: vol's cell_pack(), where the caller holds it already."""
    shape = device_const(tuple(vol.shape), pts01.dtype, pts01.device)
    g = pts01 * 2.0 - 1.0
    if align_corners:
        coords = (g + 1.0) / 2.0 * (shape - 1.0)
    else:
        coords = ((g + 1.0) * shape - 1.0) / 2.0
    return _trilerp(vol, coords, cells)
