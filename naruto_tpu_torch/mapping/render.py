"""Depth-guided volumetric SDF rendering (counterpart of
naruto_tpu/mapping/render.py).

z sampling: n_range_d samples in +-range_d around the measured depth (rays
without valid depth fall back to near..far) merged with n_samples_d uniform
near..far samples, then stratified-perturbed with a U[0, 1) draw that the
caller passes in (``z_noise``). With n_importance > 0 the first pass's
weights are a PDF over the bins between its samples, n_importance more z
values are drawn from it by inverse CDF (the U[0, 1) draws ``importance_u``
are the caller's too, evenly spaced when perturb == 0), and the merged
samples are rendered again; the first pass's maps come back with a "0"
suffix. No loss reads them, so the first pass's field query takes a
cotangent only through the points that ride it (``extra_pts01``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from naruto_tpu_torch.mapping.field import (FieldSpec, field_query,
                                            field_query_plus_embed,
                                            normalize_world)
from naruto_tpu_torch.ops import device_const, unit_linspace


class RenderConfig(NamedTuple):
    near: float = 0.0
    far: float = 5.0
    n_range_d: int = 11
    range_d: float = 0.1
    n_samples_d: int = 32
    n_importance: int = 0
    perturb: float = 1.0
    trunc: float = 0.1
    sc_factor: float = 1.0

    @property
    def n_samples(self) -> int:
        return self.n_range_d + self.n_samples_d


def sample_z_vals(target_d: torch.Tensor, rc: RenderConfig,
                  z_noise: Optional[torch.Tensor]) -> torch.Tensor:
    """target_d [N, 1] -> sorted z values [N, S]; z_noise [N, S] U[0, 1)
    (required when rc.perturb > 0)."""
    n = target_d.shape[0]
    dev = target_d.device
    z_depth = torch.linspace(-rc.range_d, rc.range_d, rc.n_range_d,
                             device=dev)[None, :] + target_d
    z_fallback = torch.linspace(rc.near, rc.far, rc.n_range_d,
                                device=dev).expand(n, rc.n_range_d)
    z_vals = torch.where(target_d <= 0, z_fallback, z_depth)
    if rc.n_samples_d > 0:
        # merging two sorted lists: a sort gives the same values as the JAX
        # package's rank-arithmetic merge
        z_uniform = torch.linspace(rc.near, rc.far, rc.n_samples_d,
                                   device=dev).expand(n, rc.n_samples_d)
        z_vals = torch.sort(torch.cat([z_vals, z_uniform], dim=-1),
                            dim=-1).values
    if rc.perturb > 0:
        if z_noise is None:
            raise ValueError("perturb > 0 needs z_noise [N, S] in U[0, 1)")
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * z_noise
    return z_vals


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               u: Optional[torch.Tensor] = None,
               det: bool = False) -> torch.Tensor:
    """Inverse-CDF sampling of the piecewise-constant PDF over bins [N, B]
    with weights [N, B-1] (+1e-5, so no PDF is zero) -> [N, n_importance]
    z values. u [N, n_importance] in U[0, 1) is required unless det, which
    spaces u evenly over [0, 1] (jnp.linspace's float32 values)."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]),
                     torch.cumsum(pdf, dim=-1)], dim=-1)          # [N, B]
    n = cdf.shape[0]
    if det:
        u = device_const(tuple(unit_linspace(n_importance).tolist()),
                         torch.float32, cdf.device).expand(n, n_importance)
    elif u is None:
        raise ValueError("det=False needs u [N, n_importance] in U[0, 1)")
    # searchsorted(cdf, u, right=True) == #(cdf <= u)
    inds = torch.sum(cdf[:, None, :] <= u[:, :, None], dim=-1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sdf2weights(sdf: torch.Tensor, z_vals: torch.Tensor,
                rc: RenderConfig) -> torch.Tensor:
    """sdf, z_vals [N, S] -> normalized weights [N, S]: bell weights
    masked to before the first sign change (+ one truncation)."""
    tr = rc.trunc
    w = torch.sigmoid(sdf / tr) * torch.sigmoid(-sdf / tr)
    crossing = (sdf[:, 1:] * sdf[:, :-1] < 0.0).to(torch.float32)
    first = torch.argmax(crossing, dim=-1)                 # 0 if none
    z_min = torch.gather(z_vals, -1, first[:, None])
    mask = (z_vals < z_min + rc.sc_factor * tr).to(torch.float32)
    w = w * mask
    return w / (torch.sum(w, dim=-1, keepdim=True) + 1e-8)


def _maps(raw: torch.Tensor, z_vals: torch.Tensor, spec: FieldSpec,
          rc: RenderConfig) -> Dict[str, torch.Tensor]:
    """raw [N, S, 5] at z_vals [N, S] -> the rendered maps."""
    rgb = torch.sigmoid(raw[..., :3])
    sdf = raw[..., 3]
    weights = sdf2weights(sdf, z_vals, rc)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    out = {
        "rgb": torch.sum(weights[..., None] * rgb, dim=-2),
        "depth": depth_map,
        "depth_var": torch.sum(
            weights * torch.square(z_vals - depth_map[:, None]), dim=-1),
        "acc": acc_map,
        "disp": 1.0 / torch.clamp(depth_map / (acc_map + 1e-10), min=1e-10),
        "z_vals": z_vals, "sdf": sdf, "weights": weights,
    }
    if spec.has_uncert:
        uncert = torch.nn.functional.softplus(raw[..., 4]) + 0.01
        out["uncert_map"] = torch.sum(weights * weights * uncert, dim=-1)
    return out


def _ray_points01(spec: FieldSpec, rays_o, rays_d, z_vals):
    """The normalized points at z_vals [N, S] along the rays -> [N*S, 3]."""
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    return normalize_world(pts.reshape(-1, 3), spec)


def render_rays(params, spec: FieldSpec, rc: RenderConfig,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                target_d: torch.Tensor, z_noise: Optional[torch.Tensor],
                extra_pts01: Optional[torch.Tensor] = None,
                importance_u: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """rays_o/d [N, 3] world, target_d [N, 1] -> rendered maps and raw
    field outputs. ``extra_pts01`` (normalized) rides the first pass's hash
    encode and comes back as "extra_embed". ``importance_u`` [N,
    n_importance] U[0, 1): the importance draws (n_importance > 0 and
    perturb > 0)."""
    n = rays_o.shape[0]
    z_vals = sample_z_vals(target_d, rc, z_noise)
    s = z_vals.shape[-1]
    x01 = _ray_points01(spec, rays_o, rays_d, z_vals)
    extra_embed = None
    if extra_pts01 is not None:
        raw, extra_embed = field_query_plus_embed(params, x01, extra_pts01,
                                                  spec)
    else:
        raw = field_query(params, x01, spec)
    out = _maps(raw.reshape(n, s, 5), z_vals, spec, rc)
    if rc.n_importance > 0:
        coarse = out
        z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        z_samples = sample_pdf(z_mid, coarse["weights"][:, 1:-1],
                               rc.n_importance, importance_u,
                               det=rc.perturb == 0.0).detach()
        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                           dim=-1).values
        raw = field_query(params,
                          _ray_points01(spec, rays_o, rays_d, z_all), spec)
        out = _maps(raw.reshape(n, s + rc.n_importance, 5), z_all, spec, rc)
        for k in ("rgb", "depth", "depth_var", "acc", "disp"):
            out[k + "0"] = coarse[k]
        out["z_std"] = torch.std(z_samples, dim=-1, unbiased=False)
    if extra_embed is not None:
        out["extra_embed"] = extra_embed
    return out
