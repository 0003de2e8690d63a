"""The neural scene field: hash-grid + one-blob encoded SDF/colour/uncertainty
(counterpart of naruto_tpu/mapping/field.py).

The field is a frozen ``FieldSpec`` plus a plain dict of tensors with the
JAX package's structure, so weights cross between the two unchanged:
  {"table": hash-grid table (ops/encoding.py), "sdf_mlp": [W...],
   "color_mlp": [W...], "uncert_grid": [X, Y, Z]}.

Wiring: h = HashGrid(x01) [L*F]; p = OneBlob(x01) [3*bins];
sdf MLP([h, p]) -> [sdf, geo(15)]; colour MLP([p, geo]) -> rgb;
uncertainty = trilinear sample of the learnable grid (align_corners=False).
Raw output channels [rgb(3), sdf, uncert]; SDF in truncation units.
The query points carry gradients (to the poses they came from) only where
``diff_positions`` is set, as in the JAX package: with tracking on.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from naruto_tpu_torch.geometry.voxel import volume_shape
from naruto_tpu_torch.ops import device_const
from naruto_tpu_torch.ops.encoding import (HashGridSpec, hash_encode,
                                           init_hash_table)
from naruto_tpu_torch.ops.grid_sample import trilinear_sample
from naruto_tpu_torch.ops.mlp import init_mlp_params, mlp_apply
from naruto_tpu_torch.ops.one_blob import one_blob_encode

Params = Dict[str, object]


@dataclass(frozen=True)
class FieldSpec:
    bound: Tuple[Tuple[float, float], ...]  # scene AABB (meters)
    n_levels: int = 4
    n_features: int = 8
    log2_hashmap_size: int = 16
    base_resolution: int = 16
    table_dtype: str = "bfloat16"
    table_layout: str = "hybrid"
    sort_carry: str = "frac"
    voxel_sdf: float = 0.02
    pos_n_bins: int = 16
    geo_feat_dim: int = 15
    hidden_dim: int = 32
    num_layers: int = 2
    hidden_dim_color: int = 32
    num_layers_color: int = 2
    uncert_grid: bool = True
    pred_uncert: bool = False
    uncert_voxel_size: float = 0.1
    diff_positions: bool = False           # gradients reach the points

    @functools.cached_property
    def hash_spec(self) -> HashGridSpec:
        return HashGridSpec.from_bound(
            np.asarray(self.bound), voxel_sdf=self.voxel_sdf,
            n_levels=self.n_levels, n_features=self.n_features,
            log2_table_size=self.log2_hashmap_size,
            base_resolution=self.base_resolution,
            gather_dtype=self.table_dtype, layout=self.table_layout,
            sort_carry=self.sort_carry)

    @functools.cached_property
    def uncert_shape(self) -> Tuple[int, int, int]:
        return volume_shape(np.asarray(self.bound), self.uncert_voxel_size)

    @property
    def hash_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def pos_dim(self) -> int:
        return 3 * self.pos_n_bins

    @property
    def bound_np(self) -> np.ndarray:
        return np.asarray(self.bound, dtype=np.float32)

    @property
    def has_uncert(self) -> bool:
        return self.uncert_grid or self.pred_uncert

    def sdf_mlp_dims(self):
        out = 1 + self.geo_feat_dim + (1 if self.pred_uncert else 0)
        return ([self.hash_dim + self.pos_dim]
                + [self.hidden_dim] * (self.num_layers - 1) + [out])

    def color_mlp_dims(self):
        return ([self.pos_dim + self.geo_feat_dim]
                + [self.hidden_dim_color] * (self.num_layers_color - 1) + [3])


def init_field_params(spec: FieldSpec, generator: torch.Generator,
                      device="cpu") -> Params:
    params: Params = {
        "table": init_hash_table(spec.hash_spec, generator, device),
        "sdf_mlp": init_mlp_params(spec.sdf_mlp_dims(), generator, device),
        "color_mlp": init_mlp_params(spec.color_mlp_dims(), generator,
                                     device),
    }
    if spec.uncert_grid:
        params["uncert_grid"] = torch.full(spec.uncert_shape, 3.0,
                                           device=device)
    return params


def normalize_world(pts: torch.Tensor, spec: FieldSpec) -> torch.Tensor:
    """World (meters) -> [0, 1]^3 field domain."""
    bound = device_const(spec.bound, torch.float32, pts.device)
    return (pts - bound[:, 0]) / (bound[:, 1] - bound[:, 0])


def _points(spec: FieldSpec, *x01: torch.Tensor):
    """The query points, cut from the graph unless spec.diff_positions."""
    return x01 if spec.diff_positions else tuple(x.detach() for x in x01)


def query_uncert(params: Params, x01: torch.Tensor) -> torch.Tensor:
    """Raw (pre-softplus) uncertainty from the learnable grid."""
    return trilinear_sample(params["uncert_grid"], x01, align_corners=False)


def _heads(params: Params, x01: torch.Tensor, h: torch.Tensor,
           spec: FieldSpec):
    """(sdf, geo, raw uncert, one-blob p) from hash features h."""
    p = one_blob_encode(x01, spec.pos_n_bins)
    out = mlp_apply(params["sdf_mlp"], torch.cat([h, p], dim=-1))
    sdf = out[:, 0]
    if spec.pred_uncert:
        return sdf, out[:, 1:-1], out[:, -1], p
    uncert = (query_uncert(params, x01) if spec.uncert_grid
              else torch.zeros_like(sdf))
    return sdf, out[:, 1:], uncert, p


def field_query(params: Params, x01: torch.Tensor,
                spec: FieldSpec) -> torch.Tensor:
    """Full raw query -> [N, 5]: [rgb(3) pre-sigmoid, sdf, uncert]."""
    x01, = _points(spec, x01)
    h = hash_encode(params["table"], x01, spec.hash_spec)
    sdf, geo, uncert, p = _heads(params, x01, h, spec)
    rgb = mlp_apply(params["color_mlp"], torch.cat([p, geo], dim=-1))
    return torch.cat([rgb, sdf[:, None], uncert[:, None]], dim=-1)


def field_query_plus_embed(params: Params, x01: torch.Tensor,
                           x01_extra: torch.Tensor, spec: FieldSpec):
    """Raw query on x01 plus hash embeddings at x01_extra, sharing ONE hash
    encode (and so one backward segment sum) for both point sets."""
    x01, x01_extra = _points(spec, x01, x01_extra)
    n = x01.shape[0]
    h_all = hash_encode(params["table"], torch.cat([x01, x01_extra]),
                        spec.hash_spec)
    sdf, geo, uncert, p = _heads(params, x01, h_all[:n], spec)
    rgb = mlp_apply(params["color_mlp"], torch.cat([p, geo], dim=-1))
    raw = torch.cat([rgb, sdf[:, None], uncert[:, None]], dim=-1)
    return raw, h_all[n:]


def query_sdf(params: Params, x01: torch.Tensor, spec: FieldSpec,
              with_uncert: bool = False):
    """SDF (and optionally raw uncertainty) at x01 [N, 3]."""
    x01, = _points(spec, x01)
    h = hash_encode(params["table"], x01, spec.hash_spec)
    sdf, _, uncert, _ = _heads(params, x01, h, spec)
    return (sdf, uncert) if with_uncert else sdf


# the surface band of the planner's uncertainty volume
SURFACE_BAND = (0.0, 0.5)


def volume_maps(params: Params, x01: torch.Tensor, spec: FieldSpec):
    """(sdf, uncert_map) at x01 [N, 3]: the uncertainty softplus(u) + 0.01
    on the surface band SURFACE_BAND of the SDF, zero off it (the mapper's
    volumes, which the planner reads)."""
    sdf, uncert = query_sdf(params, x01, spec, with_uncert=True)
    uncert_map = torch.nn.functional.softplus(uncert) + 0.01
    on_surface = (sdf >= SURFACE_BAND[0]) & (sdf < SURFACE_BAND[1])
    return sdf, torch.where(on_surface, uncert_map, 0.0)
