"""Mapping losses (counterpart of naruto_tpu/mapping/losses.py).

Every mean uses an explicit mask-aware denominator, so padded rays add
exactly nothing: rgb (per-ray weight 1 or rgb_missing), depth (valid
rays), free-space and sdf (front / truncation regions over all [N, S]
samples, each scaled by 1 - n_region/n_both), uncertainty NLL and the
smoothness TV^2 of hash embeddings on a jittered (smooth_pts-1)^3 lattice,
or (smooth_sample > 0) its unbiased Monte-Carlo estimate from
smooth_sample random neighbour pairs along each axis. The lattice's random
offset and jitter and the pairs' lattice coordinates are arguments (draws
made by the caller).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from naruto_tpu_torch.mapping.field import FieldSpec
from naruto_tpu_torch.ops import device_const


class LossWeights(NamedTuple):
    rgb: float = 5.0
    depth: float = 0.1
    sdf: float = 1000.0
    fs: float = 10.0
    uncert: float = 0.005
    smooth: float = 1e-6
    rgb_missing: float = 0.05
    trunc: float = 0.1
    sc_factor: float = 1.0
    depth_trunc: float = 100.0
    smooth_pts: int = 32
    smooth_vox: float = 0.1
    smooth_margin: float = 0.05
    smooth_sample: int = 0


def _safe_div(num, den):
    return num / torch.clamp(den, min=1.0)


def _valid_rays(target_d, ray_mask, lw: LossWeights):
    return ((target_d[:, 0] > 0.0) & (target_d[:, 0] < lw.depth_trunc)
            & (ray_mask > 0))


def _sdf_masks(z_vals, target_d, ray_mask, lw: LossWeights):
    """(front, sdf_mask) [N, S]: the free-space samples and the truncation
    band's, padded rays zeroed."""
    tr = lw.trunc * lw.sc_factor
    rm = ray_mask[:, None]
    front_raw = (z_vals < target_d - tr).to(torch.float32)
    back = (z_vals > target_d + tr).to(torch.float32)
    depth_ok = (target_d > 0.0).to(torch.float32)
    return front_raw * rm, (1.0 - front_raw) * (1.0 - back) * depth_ok * rm


def _global(counts: torch.Tensor, group) -> torch.Tensor:
    """Local counts [k], summed over the ranks of `group` (a
    parallel.mesh.Mesh) in one collective; as they are without one. They
    are masks and counts and carry no gradient."""
    if group is None:
        return counts
    # imported here: parallel/ imports this module
    from naruto_tpu_torch.parallel.mesh import all_reduce

    return all_reduce(counts.detach().clone(), "denominators")


def _rgb_depth(rend, target_rgb, target_d, ray_mask, valid, n_real, n_valid,
               lw: LossWeights):
    validf = valid.to(torch.float32)
    w = torch.where(valid, 1.0, lw.rgb_missing)[:, None] * ray_mask[:, None]
    rgb_loss = _safe_div(torch.sum(torch.square(w * (rend["rgb"] - target_rgb))),
                         n_real * 3.0)
    d_se = torch.square(rend["depth"] - target_d[:, 0]) * validf
    return rgb_loss, _safe_div(torch.sum(d_se), n_valid)


def _sdf(sdf, z_vals, target_d, front, sdf_mask, n_real, n_fs, n_sdf,
         lw: LossWeights):
    tr = lw.trunc * lw.sc_factor
    n_elems = n_real * sdf.shape[1]
    n_both = torch.clamp(n_fs + n_sdf, min=1.0)
    fs_loss = _safe_div(torch.sum(torch.square((sdf - 1.0) * front)),
                        n_elems) * (1.0 - n_fs / n_both)
    sdf_loss = _safe_div(
        torch.sum(torch.square((z_vals + sdf * tr - target_d) * sdf_mask)),
        n_elems) * (1.0 - n_sdf / n_both)
    return fs_loss, sdf_loss


def _uncert(rend, target_d, vm, n_valid, lw: LossWeights):
    nv = torch.clamp(n_valid, min=1.0)
    sigma = rend["uncert_map"] + 1e-9
    err2 = torch.square(rend["depth"] - target_d[:, 0])
    nll = torch.sum((err2 / (2.0 * sigma)) * vm) / nv
    return nll + 0.5 * torch.sum(torch.log(sigma) * vm) / nv


def smoothness_points(spec: FieldSpec, lw: LossWeights,
                      offset_u: torch.Tensor, jitter: torch.Tensor,
                      base: Optional[torch.Tensor] = None,
                      diffc: Optional[torch.Tensor] = None):
    """Normalized points of the smoothness lattice. offset_u [3] and jitter
    [3] are U[0, 1) draws. smooth_sample == 0: the full random
    (smooth_pts-1)^3 sub-grid. smooth_sample = S > 0: for each axis, S pair
    bases and their +1 neighbours along it (6S points); base [3, S, 3]
    holds lattice coordinates uniform in [0, n-1] and diffc [3, S, 1] the
    differenced coordinate uniform in [0, n-2] (integers), so only that
    coordinate is kept off the last slice. Returns (x01, n)."""
    n = lw.smooth_pts - 1
    dev = offset_u.device
    bound = device_const(spec.bound, torch.float32, dev)
    extent = bound[:, 1] - bound[:, 0]
    grid_size = n * lw.smooth_vox
    offset_max = torch.clamp(extent - grid_size - 2 * lw.smooth_margin,
                             min=0.0)
    offset = offset_u * offset_max + lw.smooth_margin
    if lw.smooth_sample:
        if base is None or diffc is None:
            raise ValueError("smooth_sample > 0 needs the pairs' base "
                             "[3, S, 3] and diffc [3, S, 1]")
        eye = torch.eye(3, device=dev)
        base = torch.where(eye[:, None, :] > 0.5, diffc.float(), base.float())
        coords = torch.cat([torch.cat([base[a], base[a] + eye[a]])
                            for a in range(3)])                   # [6S, 3]
    else:
        ax = torch.arange(n, dtype=torch.float32, device=dev)
        coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                             dim=-1).reshape(-1, 3)
    pts = (coords + jitter.reshape(1, 3)) * lw.smooth_vox + bound[:, 0] \
        + offset
    return (pts - bound[:, 0]) / extent, n


def smoothness_tv(embed: torch.Tensor, n: int, lw: LossWeights):
    """Sum of squared axis differences of the lattice embeddings divided by
    smooth_pts^3; with smooth_sample, each axis's mean over its sampled
    pairs times that axis's (n-1)*n*n pairs."""
    if lw.smooth_sample:
        s = lw.smooth_sample
        parts = embed.reshape(3, 2, s, -1)        # axis, (base, +1), pair
        tv = torch.sum(torch.mean(torch.sum(
            torch.square(parts[:, 1] - parts[:, 0]), dim=-1), dim=-1)) \
            * ((n - 1) * n * n)
        return tv / (lw.smooth_pts ** 3)
    emb = embed.reshape(n, n, n, -1)
    tv = (torch.sum(torch.square(emb[1:] - emb[:-1]))
          + torch.sum(torch.square(emb[:, 1:] - emb[:, :-1]))
          + torch.sum(torch.square(emb[:, :, 1:] - emb[:, :, :-1])))
    return tv / (lw.smooth_pts ** 3)


def total_loss(rend: Dict, target_rgb, target_d, ray_mask, lw: LossWeights,
               with_smooth: bool = True, group=None):
    """Weighted sum of the losses -> (loss, aux dict). With smoothness on,
    ``rend`` must carry the lattice embeddings as "extra_embed".

    With `group`, every denominator (real rays, rays of valid depth,
    free-space and truncation-band samples; the sample count and the
    uncertainty term's valid rays follow from them) is summed over the
    ranks in one collective, and the smoothness term, which every rank
    computes alike from the replicated lattice, enters divided by the
    number of ranks: each rank's loss and aux are its share, and summing
    the ranks' gradients once (parallel/sharded.py) gives the unsharded
    gradient."""
    valid = _valid_rays(target_d, ray_mask, lw)
    validf = valid.to(torch.float32)
    front, sdf_mask = _sdf_masks(rend["z_vals"], target_d, ray_mask, lw)
    n_real, n_valid, n_fs, n_sdf = _global(torch.stack(
        [torch.sum(ray_mask), torch.sum(validf), torch.sum(front),
         torch.sum(sdf_mask)]), group)
    rgb_l, depth_l = _rgb_depth(rend, target_rgb, target_d, ray_mask, valid,
                                n_real, n_valid, lw)
    fs_l, sdf_l = _sdf(rend["sdf"], rend["z_vals"], target_d, front,
                       sdf_mask, n_real, n_fs, n_sdf, lw)
    loss = lw.rgb * rgb_l + lw.depth * depth_l + lw.sdf * sdf_l + lw.fs * fs_l
    aux = {"rgb_loss": rgb_l, "depth_loss": depth_l, "sdf_loss": sdf_l,
           "fs_loss": fs_l}
    if "uncert_map" in rend:
        u_l = _uncert(rend, target_d, validf, n_valid, lw)
        loss = loss + lw.uncert * u_l
        aux["uncert_loss"] = u_l
    if with_smooth and lw.smooth > 0:
        s_l = smoothness_tv(rend["extra_embed"], lw.smooth_pts - 1, lw)
        if group is not None:
            s_l = s_l / group.world
        loss = loss + lw.smooth * s_l
        aux["smooth_loss"] = s_l
    aux["total"] = loss
    return loss, aux
