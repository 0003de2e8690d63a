"""The uncertainty grid's trilinear sample as the port computed it before
it read the grid itself: the grid packed into its cells' 8 corner values,
[(X-1)(Y-1)(Z-1), 8], a row gathered a sample, and the volume gradient
summed into dense cell rows whose 8 corner planes are added into a zeroed
grid. The tests hold ``ops/grid_sample.py`` to it bit for bit, on the CPU
and on a card; it imports neither jax nor the JAX package."""
import torch

from naruto_tpu_torch.ops import device_const, primitives
from naruto_tpu_torch.ops.grid_sample import _CORNERS, _corner_sel
from naruto_tpu_torch.ops.segment import dense_segment_sum


def cell_data(shape, coords: torch.Tensor):
    """coords [N, 3] voxel units -> (cell id [N] of the cell-packed view,
    weights [N, 8], frac [N, 3])."""
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
    w = t[..., 0] * t[..., 1] * t[..., 2]
    return cell, w, frac


def cell_pack(vol: torch.Tensor) -> torch.Tensor:
    """[X, Y, Z] -> [(X-1)(Y-1)(Z-1), 8]: the 8 corner values of each
    cell."""
    X, Y, Z = vol.shape
    return torch.stack([vol[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1]
                        for dx, dy, dz in _CORNERS], dim=-1).reshape(-1, 8)


def dense_vol_grad(shape, cell: torch.Tensor,
                   gw: torch.Tensor) -> torch.Tensor:
    """The grid gradient from the cell ids [N] and the weighted cotangent
    rows [N, 8]: the rows summed into every cell, then each corner plane
    added into a zeroed grid."""
    X, Y, Z = shape
    n_cells = (X - 1) * (Y - 1) * (Z - 1)
    d_cell = dense_segment_sum(cell, gw, n_cells, pack_bf16=False)
    d_cell = d_cell.reshape(X - 1, Y - 1, Z - 1, 8)
    d_vol = gw.new_zeros((X, Y, Z))
    for k, (dx, dy, dz) in enumerate(_CORNERS):
        d_vol[dx:dx + X - 1, dy:dy + Y - 1, dz:dz + Z - 1] += d_cell[..., k]
    return d_vol


class DenseTrilerp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vol, coords):
        cell, w, frac = cell_data(vol.shape, coords)
        vals = primitives.gather_rows(cell_pack(vol), cell)   # [N, 8]
        ctx.save_for_backward(cell, w, frac, vals)
        ctx.vol_shape = tuple(vol.shape)
        return torch.sum(vals * w, dim=-1)

    @staticmethod
    def backward(ctx, g):
        cell, w, frac, vals = ctx.saved_tensors
        d_vol = d_coords = None
        if ctx.needs_input_grad[0]:
            d_vol = dense_vol_grad(ctx.vol_shape, cell, g[:, None] * w)
        if ctx.needs_input_grad[1]:
            sel = _corner_sel(frac)
            t = torch.where(sel[None], frac[:, None, :],
                            1.0 - frac[:, None, :])
            sign = torch.where(sel, 1.0, -1.0).to(frac.dtype)
            p = torch.stack([t[..., 1] * t[..., 2], t[..., 0] * t[..., 2],
                             t[..., 0] * t[..., 1]], dim=-1)
            d_coords = torch.einsum("n,nc,ca,nca->na", g, vals, sign, p)
        return d_vol, d_coords


def dense_trilerp(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """In the place of ``grid_sample._trilerp``."""
    return DenseTrilerp.apply(vol, coords)
