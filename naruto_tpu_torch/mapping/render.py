"""Depth-guided volumetric SDF rendering (counterpart of
naruto_tpu/mapping/render.py).

z sampling: n_range_d samples in +-range_d around the measured depth (rays
without valid depth fall back to near..far) merged with n_samples_d uniform
near..far samples, then stratified-perturbed with a U[0, 1) draw that the
caller passes in (``z_noise``). Importance resampling (n_importance > 0) is
not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from naruto_tpu_torch.mapping.field import (FieldSpec, field_query,
                                            field_query_plus_embed,
                                            normalize_world)


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


def render_rays(params, spec: FieldSpec, rc: RenderConfig,
                rays_o: torch.Tensor, rays_d: torch.Tensor,
                target_d: torch.Tensor, z_noise: Optional[torch.Tensor],
                extra_pts01: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """rays_o/d [N, 3] world, target_d [N, 1] -> rendered maps and raw
    field outputs. ``extra_pts01`` (normalized) rides the same hash encode
    and comes back as "extra_embed"."""
    if rc.n_importance > 0:
        raise NotImplementedError("importance sampling is not ported yet")
    n = rays_o.shape[0]
    z_vals = sample_z_vals(target_d, rc, z_noise)
    s = z_vals.shape[-1]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    x01 = normalize_world(pts.reshape(-1, 3), spec)
    out = {}
    if extra_pts01 is not None:
        raw, out["extra_embed"] = field_query_plus_embed(params, x01,
                                                         extra_pts01, spec)
    else:
        raw = field_query(params, x01, spec)
    raw = raw.reshape(n, s, 5)

    rgb = torch.sigmoid(raw[..., :3])
    sdf = raw[..., 3]
    weights = sdf2weights(sdf, z_vals, rc)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    out.update({
        "rgb": torch.sum(weights[..., None] * rgb, dim=-2),
        "depth": depth_map,
        "depth_var": torch.sum(
            weights * torch.square(z_vals - depth_map[:, None]), dim=-1),
        "acc": acc_map,
        "disp": 1.0 / torch.clamp(depth_map / (acc_map + 1e-10), min=1e-10),
        "z_vals": z_vals, "sdf": sdf, "weights": weights,
    })
    if spec.has_uncert:
        uncert = torch.nn.functional.softplus(raw[..., 4]) + 0.01
        out["uncert_map"] = torch.sum(weights * weights * uncert, dim=-1)
    return out
