"""The plain reference of a mapping run: NARUTO's field, renderer, losses,
keyframe database, active-ray selection, optimizers and map volumes in
plain PyTorch, from the configuration's numbers alone.

It imports nothing of the program and takes nothing the program made: the
weights, the frames and the draws' generators come from the benchmark
(``inputs.py``, ``scene.py``), and every table, keyframe slot, pose and
volume it reads it works out itself. Gradients come from autograd; the one
hand-written backward is the hash table's gather, so that its cotangent
rows are summed in float32, as the configuration's float32 master table
is, and in a fixed order (``_sum_rows``), so that a seed's numbers repeat
from run to run.

Precision is the configuration's: float32 everywhere with TF32 off, the
table's rows gathered in ``grid.table_dtype`` and each weighted corner row
rounded to it before the float32 sum of the eight corners. The control
(``control=True`` and ``set_precision(True)``) is the same reference one
step below each stated precision: TF32 matmuls, and the table gathered in
bfloat16 where it is float32, in float8 (e4m3) where it is bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
CORNERS = tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the control's table: the nearest precision below the stated one
LOWER = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float8_e4m3fn}
EMBED_BETAS, EMBED_EPS = (0.9, 0.99), 1e-15
DECODER_BETAS, DECODER_EPS, DECODER_WD = (0.9, 0.99), 1e-8, 1e-6
SURFACE_BAND = (0.0, 0.5)
VOLUME_BLOCK = 1 << 18      # voxels a block of the reference's volume query


# ----------------------------------------------------------- grid sizes
class Grid:
    """The hash grid's sizes, from the configuration's ``grid`` section and
    the mapping bound (instant-NGP levels between base_resolution and
    max side / voxel_sdf)."""

    def __init__(self, cfg: dict):
        g = cfg["grid"]
        bound = np.asarray(cfg["mapper"]["bound"], np.float64)
        self.L, self.F = g["n_levels"], g["n_features_per_level"]
        self.T = 1 << g["hash_size"]
        self.layout = g["layout"]
        self.dtype = DTYPES[g["table_dtype"]]
        base = g["base_resolution"]
        finest = max(int(float((bound[:, 1] - bound[:, 0]).max())
                         / g["voxel_sdf"]), 16)
        scale = (1.0 if self.L == 1 else
                 float(np.exp(np.log(finest / base) / (self.L - 1))))
        self.res = [int(np.floor(base * scale ** lv + 1e-6))
                    for lv in range(self.L)]
        self.cell = self.layout in ("cell", "hybrid")
        if self.layout == "hybrid":
            cap = int(self.T * 1.25)
            self.dense = [r ** 3 <= cap for r in self.res]
        elif self.cell:
            self.dense = [r ** 3 <= self.T for r in self.res]
        else:
            self.dense = [(r + 1) ** 3 <= self.T for r in self.res]
        self.sizes = [((r ** 3 if self.cell else (r + 1) ** 3) if d
                       else self.T) for r, d in zip(self.res, self.dense)]
        self.offsets = [int(x) for x in np.cumsum([0] + self.sizes)]
        self.total = self.offsets[-1]
        self.row = 8 * self.F if self.cell else self.F

    def table_shapes(self) -> List[tuple]:
        """The table's leaves: [hash rows, 8F] then one [R+1]^3 x F vertex
        grid per dense level (hybrid), or the one [total, row] table."""
        if self.layout != "hybrid":
            return [(self.total, self.row)]
        hashed = sum(s for s, d in zip(self.sizes, self.dense) if not d)
        return [(hashed, self.row)] + [(r + 1, r + 1, r + 1, self.F)
                                       for r, d in zip(self.res, self.dense)
                                       if d]


def param_shapes(cfg: dict) -> Dict[str, List[tuple]]:
    """Every leaf of the field, by optimizer group, in the groups' order:
    table, decoder (SDF MLP then colour MLP, [in, out] matrices),
    uncertainty grid."""
    d, g = cfg["decoder"], cfg["grid"]
    pos = 3 * g["pos_n_bins"]
    hash_dim = g["n_levels"] * g["n_features_per_level"]
    sdf = ([hash_dim + pos] + [d["hidden_dim"]] * (d["num_layers"] - 1)
           + [1 + d["geo_feat_dim"]])
    col = ([pos + d["geo_feat_dim"]]
           + [d["hidden_dim_color"]] * (d["num_layers_color"] - 1) + [3])
    mlp = [(a, b) for a, b in zip(sdf[:-1], sdf[1:])] + \
          [(a, b) for a, b in zip(col[:-1], col[1:])]
    return {"table": Grid(cfg).table_shapes(), "decoder": mlp,
            "uncert": [volume_shape(cfg["mapper"]["bound"],
                                    cfg["mapper"]["voxel_size"])]}


def volume_shape(bound, voxel: float) -> tuple:
    b = np.asarray(bound, np.float64)
    return tuple(int(round((b[i, 1] - b[i, 0]) / voxel + 0.0005)) + 1
                 for i in range(3))


def world_grid01(bound, voxel: float) -> np.ndarray:
    """The voxel grid's points in [0, 1]^3, [X*Y*Z, 3] f32."""
    b = np.asarray(bound, np.float32)
    axes = [np.linspace(b[i, 0], b[i, 1],
                        volume_shape(bound, voxel)[i], dtype=np.float32)
            for i in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return ((grid - b[:, 0]) / (b[:, 1] - b[:, 0])).astype(np.float32)


# ------------------------------------------------------------ the field
def quant(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype`, as float32 values; float8 with one scale a
    tensor (its largest magnitude at the format's largest value)."""
    if dtype == torch.float32:
        return x
    if dtype == torch.bfloat16:
        return x.to(dtype).to(torch.float32)
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    return (x / scale).to(dtype).to(torch.float32) * scale


def _sum_rows(idx: torch.Tensor, g: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, F] float32: row i the sum of the rows of g whose idx is i, in
    a fixed order (torch's deterministic index_put_: on a card a stable
    sort by row, then each row's terms in turn), not by atomic adds, whose
    order changes from run to run."""
    d = g.new_zeros((rows, g.shape[-1]), dtype=torch.float32)
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        d.index_put_((idx,), g.float(), accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
    return d


class _Gather(torch.autograd.Function):
    """rows = quant(table)[idx]; the cotangent rows summed into a float32
    table by _sum_rows."""

    @staticmethod
    def forward(ctx, table, idx, dtype):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return quant(table, dtype)[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return _sum_rows(idx, g, ctx.rows), None, None


class _Round(torch.autograd.Function):
    """x rounded to `dtype` (float32 values); the cotangent rounded alike,
    as the product's backward in that dtype gives it."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return quant(x, dtype)

    @staticmethod
    def backward(ctx, g):
        return quant(g, ctx.dtype), None


def _hash(x, y, z, T: int):
    return (((x * _PRIMES[0]) & _U32) ^ ((y * _PRIMES[1]) & _U32)
            ^ ((z * _PRIMES[2]) & _U32)) & (T - 1)


def _corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 8] trilinear weights in CORNERS order, the
    product taken x, y, z."""
    sel = torch.tensor(CORNERS, dtype=torch.bool, device=frac.device)
    t = torch.where(sel, frac[..., None, :], 1.0 - frac[..., None, :])
    return t[..., 0] * t[..., 1] * t[..., 2]


def hash_encode(grid: Grid, leaves: Sequence[torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """x [N, 3] in [0, 1] -> [N, L*F] f32 features."""
    n, dev = x.shape[0], x.device
    res_f = torch.tensor(grid.res, dtype=torch.float32, device=dev)
    res_i = torch.tensor(grid.res, dtype=torch.int64, device=dev)
    pos = x[:, None, :] * res_f[None, :, None]
    i0 = torch.minimum(torch.clamp(torch.floor(pos).long(), min=0),
                       (res_i - 1)[None, :, None])
    frac = torch.clamp(pos - i0.float(), 0.0, 1.0)
    w = _corner_weights(frac)                                  # [N, L, 8]
    dense = torch.tensor(grid.dense, device=dev)
    offs = torch.tensor(grid.offsets[:-1], dtype=torch.int64, device=dev)
    if grid.cell:
        cx, cy, cz = i0[..., 0], i0[..., 1], i0[..., 2]
        s = res_i[None, :]
        idx = torch.where(dense[None], cx + cy * s + cz * s * s,
                          _hash(cx, cy, cz, grid.T)) + offs[None]
    else:
        c = torch.tensor(CORNERS, dtype=torch.int64, device=dev)
        cx, cy, cz = (i0[..., a, None] + c[:, a] for a in range(3))
        s = (res_i + 1)[None, :, None]
        idx = torch.where(dense[None, :, None], cx + cy * s + cz * s * s,
                          _hash(cx, cy, cz, grid.T)) + offs[None, :, None]
    table = _full_table(grid, leaves)
    rows = _Gather.apply(table, idx.reshape(-1), grid.dtype)
    rows = rows.reshape(n, grid.L, 8, grid.F)
    weighted = _Round.apply(rows * quant(w, grid.dtype)[..., None],
                            grid.dtype)
    return weighted.sum(dim=2).reshape(n, -1)


def _full_table(grid: Grid, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The table of gathered rows: hybrid levels' dense vertex grids turned
    into cell rows (corner c's features at columns [cF, (c+1)F])."""
    if grid.layout != "hybrid":
        return leaves[0]
    blocks, di, hoff = [], 1, 0
    for r, size, d in zip(grid.res, grid.sizes, grid.dense):
        if d:
            v = leaves[di]
            blocks.append(torch.cat([v[cz:cz + r, cy:cy + r, cx:cx + r]
                                     for cx, cy, cz in CORNERS], -1)
                          .reshape(r ** 3, 8 * grid.F))
            di += 1
        else:
            blocks.append(leaves[0][hoff:hoff + size])
            hoff += size
    return torch.cat(blocks)


def trilinear(vol: torch.Tensor, x01: torch.Tensor) -> torch.Tensor:
    """vol [X, Y, Z] at points in [0, 1]^3 (align_corners=False, clamped
    to the border)."""
    X, Y, Z = vol.shape
    shape = torch.tensor([X, Y, Z], dtype=x01.dtype, device=x01.device)
    c = ((x01 * 2.0 - 1.0 + 1.0) * shape - 1.0) / 2.0
    c = torch.minimum(torch.clamp(c, min=0.0), shape - 1.0)
    i0 = torch.minimum(torch.clamp(torch.floor(c).long(), min=0),
                       (shape - 2.0).long())
    frac = c - i0.to(c.dtype)
    vals = torch.stack([vol[i0[:, 0] + a, i0[:, 1] + b, i0[:, 2] + e]
                        for a, b, e in CORNERS], -1)
    return torch.sum(vals * _corner_weights(frac), dim=-1)


def one_blob(x: torch.Tensor, bins: int) -> torch.Tensor:
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=x.dtype, device=x.device)
    z = (edges - x[..., None]) / ((1.0 / bins) * math.sqrt(2.0))
    cdf = 0.5 * (1.0 + torch.special.erf(z))
    return (cdf[..., 1:] - cdf[..., :-1]).reshape(*x.shape[:-1], -1)


def mlp(ws: Sequence[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    for i, w in enumerate(ws):
        h = h @ w
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


class Field:
    """The field's leaves (float32, trainable) and its queries."""

    def __init__(self, cfg: dict, leaves: Dict[str, List[torch.Tensor]],
                 control: bool = False):
        self.cfg, self.grid = cfg, Grid(cfg)
        if control:
            self.grid.dtype = LOWER[self.grid.dtype]
        self.bins = cfg["grid"]["pos_n_bins"]
        self.n_sdf = cfg["decoder"]["num_layers"]
        self.groups = {k: [t.detach().clone().float().requires_grad_(True)
                           for t in v] for k, v in leaves.items()}
        b = np.asarray(cfg["mapper"]["bound"], np.float32)
        dev = self.groups["uncert"][0].device
        self.lo = torch.from_numpy(b[:, 0]).to(dev)
        self.extent = torch.from_numpy(b[:, 1] - b[:, 0]).to(dev)

    def leaves(self) -> List[torch.Tensor]:
        return [t for g in self.groups.values() for t in g]

    def _heads(self, x01, h):
        dec = self.groups["decoder"]
        p = one_blob(x01, self.bins)
        out = mlp(dec[:self.n_sdf], torch.cat([h, p], -1))
        return out[:, 0], out[:, 1:], trilinear(self.groups["uncert"][0],
                                                x01), p

    def query(self, x01: torch.Tensor) -> torch.Tensor:
        """-> [N, 5]: rgb (pre-sigmoid), sdf, raw uncertainty."""
        h = hash_encode(self.grid, self.groups["table"], x01)
        sdf, geo, unc, p = self._heads(x01, h)
        rgb = mlp(self.groups["decoder"][self.n_sdf:], torch.cat([p, geo], -1))
        return torch.cat([rgb, sdf[:, None], unc[:, None]], -1)

    def embed(self, x01: torch.Tensor) -> torch.Tensor:
        return hash_encode(self.grid, self.groups["table"], x01)

    @torch.no_grad()
    def volumes(self, grid01: torch.Tensor):
        """(uncert_map, sdf) on the voxel points: softplus(u) + 0.01 on the
        surface band of the SDF, 0 off it."""
        h = hash_encode(self.grid, self.groups["table"], grid01)
        sdf, _, unc, _ = self._heads(grid01, h)
        on = (sdf >= SURFACE_BAND[0]) & (sdf < SURFACE_BAND[1])
        return torch.where(on, torch.nn.functional.softplus(unc) + 0.01,
                           0.0), sdf


# ------------------------------------------------------- render + losses
def sample_z(target_d, tr: dict, noise):
    n, dev = target_d.shape[0], target_d.device
    nr, nu = tr["n_range_d"], tr["n_samples_d"]
    near, far = tr["near"], tr["far"]
    z = torch.linspace(-tr["range_d"], tr["range_d"], nr,
                       device=dev)[None, :] + target_d
    z = torch.where(target_d <= 0, torch.linspace(near, far, nr, device=dev)
                    .expand(n, nr), z)
    if nu > 0:
        z = torch.sort(torch.cat([z, torch.linspace(near, far, nu, device=dev)
                                  .expand(n, nu)], -1), -1).values
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], -1)
    lower = torch.cat([z[:, :1], mids], -1)
    return lower + (upper - lower) * noise


def render(field: Field, tr: dict, rays_o, rays_d, target_d, noise):
    n = rays_o.shape[0]
    z = sample_z(target_d, tr, noise)
    s = z.shape[-1]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    x01 = ((pts.reshape(-1, 3) - field.lo) / field.extent).detach()
    raw = field.query(x01).reshape(n, s, 5)
    sdf = raw[..., 3]
    t = tr["trunc"]
    w = torch.sigmoid(sdf / t) * torch.sigmoid(-sdf / t)
    first = torch.argmax((sdf[:, 1:] * sdf[:, :-1] < 0.0).float(), -1)
    z_min = torch.gather(z, -1, first[:, None])
    w = w * (z < z_min + tr["sc_factor"] * t).float()
    w = w / (torch.sum(w, -1, keepdim=True) + 1e-8)
    depth = torch.sum(w * z, -1)
    unc = torch.nn.functional.softplus(raw[..., 4]) + 0.01
    return {"rgb": torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), -2),
            "depth": depth, "uncert_map": torch.sum(w * w * unc, -1),
            "z_vals": z, "sdf": sdf}


def _sd(num, den):
    return num / torch.clamp(den, min=1.0)


def losses(rend, rgb, depth, mask, tr: dict, depth_trunc: float,
           smooth=None):
    """(the weighted loss, its terms by the mapper's names); smooth: the
    smoothness TV already divided by smooth_pts^3, or None."""
    valid = (depth[:, 0] > 0.0) & (depth[:, 0] < depth_trunc) & (mask > 0)
    vf = valid.float()
    t = tr["trunc"] * tr["sc_factor"]
    z = rend["z_vals"]
    front = (z < depth - t).float() * mask[:, None]
    back = (z > depth + t).float()
    band = ((1.0 - (z < depth - t).float()) * (1.0 - back)
            * (depth > 0.0).float() * mask[:, None])
    n_real, n_valid = torch.sum(mask), torch.sum(vf)
    n_fs, n_sdf = torch.sum(front), torch.sum(band)
    wr = torch.where(valid, 1.0, tr["rgb_missing"])[:, None] * mask[:, None]
    rgb_l = _sd(torch.sum(torch.square(wr * (rend["rgb"] - rgb))),
                n_real * 3.0)
    depth_l = _sd(torch.sum(torch.square(rend["depth"] - depth[:, 0]) * vf),
                  n_valid)
    n_el = n_real * z.shape[1]
    n_both = torch.clamp(n_fs + n_sdf, min=1.0)
    sdf = rend["sdf"]
    fs_l = _sd(torch.sum(torch.square((sdf - 1.0) * front)), n_el) \
        * (1.0 - n_fs / n_both)
    sdf_l = _sd(torch.sum(torch.square((z + sdf * t - depth) * band)),
                n_el) * (1.0 - n_sdf / n_both)
    loss = (tr["rgb_weight"] * rgb_l + tr["depth_weight"] * depth_l
            + tr["sdf_weight"] * sdf_l + tr["fs_weight"] * fs_l)
    nv = torch.clamp(n_valid, min=1.0)
    sigma = rend["uncert_map"] + 1e-9
    err2 = torch.square(rend["depth"] - depth[:, 0])
    unc_l = (torch.sum((err2 / (2.0 * sigma)) * vf) / nv
             + 0.5 * torch.sum(torch.log(sigma) * vf) / nv)
    loss = loss + tr["uncert_weight"] * unc_l
    terms = {"rgb_loss": rgb_l, "depth_loss": depth_l, "sdf_loss": sdf_l,
             "fs_loss": fs_l, "uncert_loss": unc_l}
    if smooth is not None:
        loss = loss + tr["smooth_weight"] * smooth
        terms["smooth_loss"] = smooth
    terms["total"] = loss
    return loss, terms


def smoothness(field: Field, tr: dict, offset_u, jitter):
    """The TV^2 of hash embeddings on a jittered (smooth_pts-1)^3 lattice at
    a random offset, divided by smooth_pts^3."""
    n = tr["smooth_pts"] - 1
    vox, margin = tr["smooth_vox"], tr["smooth_margin"]
    off = offset_u * torch.clamp(field.extent - n * vox - 2 * margin,
                                 min=0.0) + margin
    ax = torch.arange(n, dtype=torch.float32, device=offset_u.device)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                         -1).reshape(-1, 3)
    pts = (coords + jitter.reshape(1, 3)) * vox + field.lo + off
    e = field.embed((pts - field.lo) / field.extent).reshape(n, n, n, -1)
    tv = (torch.sum(torch.square(e[1:] - e[:-1]))
          + torch.sum(torch.square(e[:, 1:] - e[:, :-1]))
          + torch.sum(torch.square(e[:, :, 1:] - e[:, :, :-1])))
    return tv / tr["smooth_pts"] ** 3


# ------------------------------------------------------------ the mapper
def _floats(terms: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.detach()) for k, v in terms.items()}


def _transform(rays, poses):
    return (poses[:, :3, 3], torch.einsum("nij,nj->ni", poses[:, :3, :3],
                                          rays[:, :3]),
            rays[:, 3:6], rays[:, 6:7])


class Mapping:
    """A mapping run's state: the field, its three optimizers, the
    keyframe database, the pose table and the uncertainty volume. The
    draws come from `gens` ({site name: torch.Generator}) in the order and
    shapes that NARUTO's mapper draws them."""

    def __init__(self, cfg: dict, leaves: Dict[str, List[torch.Tensor]],
                 gens: Dict[str, torch.Generator], device, n_poses: int,
                 kf_slots: int, control: bool = False):
        self.cfg, self.gens, self.dev = cfg, gens, torch.device(device)
        m, c, t = cfg["mapper"], cfg["cam"], cfg["training"]
        self.m = m
        self.tr = dict(t, near=c["near"], far=c["far"])
        self.depth_trunc = c["depth_trunc"]
        self.field = Field(cfg, leaves, control)
        f = self.field.groups
        self.opt_table = torch.optim.Adam(f["table"], lr=m["lr_embed"],
                                          betas=EMBED_BETAS, eps=EMBED_EPS)
        self.opt_dec = torch.optim.Adam(f["decoder"], lr=m["lr_decoder"],
                                        betas=DECODER_BETAS, eps=DECODER_EPS,
                                        weight_decay=DECODER_WD)
        self.opt_unc = torch.optim.Adam(f["uncert"], lr=m["lr_uncert"],
                                        betas=DECODER_BETAS, eps=DECODER_EPS)
        self.unc_accum = torch.zeros_like(f["uncert"][0])
        ds = c["downsample"]
        self.H, self.W = c["H"] // ds, c["W"] // ds
        u, v = np.meshgrid(np.arange(self.W, dtype=np.float32),
                           np.arange(self.H, dtype=np.float32), indexing="xy")
        fx, fy, cx, cy = (c["fx"] // ds, c["fy"] // ds, c["cx"] // ds,
                          c["cy"] // ds)
        dirs = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
        self.dirs = torch.from_numpy(dirs.astype(np.float32).reshape(-1, 3)
                                     ).to(self.dev)
        self.quota = max(int(self.H * self.W * m["n_pixels"]), 1)
        self.kf_rays = torch.zeros((kf_slots * self.quota, 7), device=self.dev)
        self.kf_count = 0
        self.poses = torch.eye(4, device=self.dev).repeat(n_poses, 1, 1)
        self.vol_shape = volume_shape(m["bound"], m["voxel_size"])
        self.grid01 = torch.from_numpy(world_grid01(m["bound"],
                                                    m["voxel_size"])
                                       ).to(self.dev)
        self.uncert_vol = torch.zeros(self.vol_shape, device=self.dev)
        b = np.asarray(m["bound"], np.float32)
        self.vol_lo = torch.from_numpy(b[:, 0]).to(self.dev)
        self.vol_max = torch.tensor([s - 1 for s in self.vol_shape],
                                    device=self.dev)
        self.n_os = m["sample"] * (m["act_ray_oversample_mul"]
                                   if m["active_ray"] else 1)
        self.min_cur = m["min_pixels_cur"] * (m["act_ray_oversample_mul"]
                                              if m["active_ray"] else 1)

    def frame_rays(self, color_u8, depth) -> torch.Tensor:
        col = color_u8.reshape(-1, 3).float() * (1.0 / 255.0)
        return torch.cat([self.dirs, col, depth.reshape(-1, 1).float()], -1)

    def add_keyframe(self, rays) -> None:
        d = rays[:, 6]
        valid = ((d > 0.0) & (d <= self.depth_trunc) if self.m["filter_depth"]
                 else torch.ones_like(d, dtype=torch.bool))
        u = torch.rand((rays.shape[0],), device=self.dev,
                       generator=self.gens["keyframe_scores"])
        idx = torch.sort(u + torch.where(valid, 0.0, 2.0),
                         stable=True).indices[:self.quota]
        pos = torch.arange(self.quota, device=self.dev)
        pos = torch.where(pos < valid.sum(),
                          pos, pos % torch.clamp(valid.sum(), min=1))
        k = self.kf_count
        self.kf_rays[k * self.quota:(k + 1) * self.quota] = rays[idx[pos]]
        self.kf_count += 1

    def volumes(self) -> torch.Tensor:
        """The SDF volume; the uncertainty volume into ``uncert_vol``. In
        blocks of VOLUME_BLOCK voxels, so that a large scene's grid
        fits."""
        parts = [self.field.volumes(self.grid01[i:i + VOLUME_BLOCK])
                 for i in range(0, self.grid01.shape[0], VOLUME_BLOCK)]
        self.uncert_vol = torch.cat([u for u, _ in parts]).reshape(
            self.vol_shape)
        return torch.cat([s for _, s in parts]).reshape(self.vol_shape)

    def _step(self, loss) -> None:
        """Backward, the table's and the decoder's Adam steps; the
        uncertainty grid's gradient is accumulated."""
        f = self.field.groups
        for opt in (self.opt_table, self.opt_dec, self.opt_unc):
            opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt_table.step()
        self.opt_dec.step()
        self.unc_accum += f["uncert"][0].grad
        f["uncert"][0].grad = None

    def _uncert_step(self) -> None:
        self.field.groups["uncert"][0].grad = self.unc_accum.clone()
        self.opt_unc.step()
        self.opt_unc.zero_grad(set_to_none=True)
        self.unc_accum.zero_()

    def bucket(self) -> int:
        need = max(self.n_os // max(self.kf_count, 1), self.min_cur)
        return next((b for b in (512, 2048, 8192) if b >= need), 8192)

    def ba(self, cur_cap: int, rays, c2w,
           frame_id: int) -> List[Dict[str, float]]:
        """One global BA call of `iters` iterations on keyframe rays and the
        current frame's, with active-ray selection; returns each
        iteration's loss terms."""
        m, dev = self.m, self.dev
        self.poses[frame_id] = c2w
        d = rays[:, 6]
        valid = (d > 0.0) & (d <= self.depth_trunc)
        n_valid = max(int(valid.sum()), 1)
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        num_cur = min(max(self.n_os // max(self.kf_count, 1), self.min_cur),
                      cur_cap, n_valid)
        total = max(self.kf_count * self.quota, 1)
        s = self.tr["n_range_d"] + self.tr["n_samples_d"]
        base, k_sel = m["sample"], m["act_ray_num_uncert_sample"]
        keep_cap = cur_cap // 4
        cand_cap = cur_cap - keep_cap
        num_keep = num_cur // 4
        n_rays = base + keep_cap
        out = []
        for it in range(m["iters"]):
            g_idx = torch.randint(0, total, (self.n_os,), device=dev,
                                  generator=self.gens["global_rays"])
            cur_j = torch.randint(0, n_valid, (cur_cap,), device=dev,
                                  generator=self.gens["current_rays"])
            noise = torch.rand((n_rays, s), device=dev,
                               generator=self.gens["z_noise"])
            off_u = torch.rand((3,), device=dev,
                               generator=self.gens["smoothness"])
            jit = torch.rand((3,), device=dev,
                             generator=self.gens["smoothness"])
            g = _transform(self.kf_rays[g_idx],
                           self.poses[(g_idx // self.quota)
                                      * m["keyframe_every"]])
            cu = _transform(rays[order[cur_j]], c2w.expand(cur_cap, 4, 4))
            cand_valid = torch.cat([
                torch.ones((self.n_os - base,), dtype=torch.bool, device=dev),
                torch.arange(cand_cap, device=dev) < num_cur - num_keep])
            co = torch.cat([g[0][base:], cu[0][:cand_cap]])
            cd = torch.cat([g[1][base:], cu[1][:cand_cap]])
            cdep = torch.cat([g[3][base:], cu[3][:cand_cap]])
            pts = co + cd * cdep
            vi = torch.round((pts - self.vol_lo)
                             * (1.0 / m["voxel_size"])).long()
            vi = torch.minimum(torch.clamp(vi, min=0), self.vol_max)
            score = self.uncert_vol[vi[:, 0], vi[:, 1], vi[:, 2]]
            if m["active_select_highest"]:
                score = -score
            score = torch.where(cand_valid, score, torch.inf)
            sel = torch.sort(score, stable=True).indices[:k_sel]
            o, dd, rgb, dep = (torch.cat([torch.cat([ga[base:],
                                                     ca[:cand_cap]])[sel],
                                          ga[:base - k_sel], ca[cand_cap:]])
                               for ga, ca in zip(g, cu))
            mask = torch.cat([torch.ones((base,), device=dev),
                              (torch.arange(keep_cap, device=dev)
                               < num_keep).float()])
            rend = render(self.field, self.tr, o, dd, dep, noise)
            tv = (smoothness(self.field, self.tr, off_u, jit)
                  if self.tr["smooth_weight"] > 0 else None)
            loss, terms = losses(rend, rgb, dep, mask, self.tr,
                                 self.depth_trunc, tv)
            self._step(loss)
            if (it + 1) % m["uncert_accum_iters"] == 0:
                self._uncert_step()
            out.append(_floats(terms))
        return out

    def state(self) -> Dict[str, List[torch.Tensor]]:
        """Leaves and first moments, by group, as host float32 tensors."""
        f = self.field.groups
        opts = {"table": self.opt_table, "decoder": self.opt_dec,
                "uncert": self.opt_unc}
        out = {}
        for k, leaves in f.items():
            out[k] = [p.detach().to("cpu", torch.float32, copy=True)
                      for p in leaves]
            out[k + ".m"] = [
                (opts[k].state[p]["exp_avg"].to("cpu", torch.float32,
                                                copy=True)
                 if p in opts[k].state else torch.zeros(p.shape))
                for p in leaves]
        return out


def set_precision(control: bool) -> None:
    """float32 matmuls in full precision, or (the control) in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
