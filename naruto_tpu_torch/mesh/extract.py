"""Mesh extraction from the neural field (counterpart of
naruto_tpu/mesh/extract.py).

Behavioral contract from coslam_utils.extract_mesh (coslam_utils.py:100-226):
chunked dense SDF query over the marching-cubes bound at the requested voxel
size -> truncation isosurfacing -> vertex rescale to metric coordinates ->
vertex coloring (field color query, or jet-colormapped uncertainty for the
uncertainty mesh) -> PLY export.

The queries run on the mapper's device in chunks of EXTRACT_CHUNK points
under no_grad. The JAX package pads its last chunk to a power of two so
that its compiled programs come from a small family; eager torch compiles
nothing, so the chunks here are not padded.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from naruto_tpu_torch.geometry.voxel import voxel_axes
from naruto_tpu_torch.mapping.field import (field_query, normalize_world,
                                            query_sdf)
from naruto_tpu_torch.mesh.marching import marching_cubes
from naruto_tpu_torch.mesh.ply import write_ply
from naruto_tpu_torch.planner.collision import trilinear_interpolation_np

MC_TRUNCATION = 3.0   # ref: coslam_utils.py:145 marching_cubes(..., 3.0)
EXTRACT_CHUNK = 1 << 20


@torch.no_grad()
def _dense_sdf(mapper, bound: np.ndarray, voxel_size: float,
               chunk: int = EXTRACT_CHUNK):
    """(sdf, raw uncert) [X, Y, Z] host arrays on the voxel grid of
    `bound`, and its axes."""
    tx, ty, tz = voxel_axes(bound, voxel_size)
    shape = (len(tx), len(ty), len(tz))
    gx, gy, gz = np.meshgrid(tx, ty, tz, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)

    field_bound = mapper.spec.bound_np
    x01 = torch.from_numpy(
        (pts - field_bound[:, 0]) / (field_bound[:, 1] - field_bound[:, 0]))
    sdf, uncert = [], []
    for s in range(0, x01.shape[0], chunk):
        sd, un = query_sdf(mapper.params, x01[s:s + chunk].to(mapper.device),
                           mapper.spec, with_uncert=True)
        sdf.append(sd)
        uncert.append(un)
    return (torch.cat(sdf).cpu().numpy().reshape(shape),
            torch.cat(uncert).cpu().numpy().reshape(shape), (tx, ty, tz))


@torch.no_grad()
def _query_colors(mapper, verts_metric: np.ndarray,
                  chunk: int = EXTRACT_CHUNK) -> np.ndarray:
    """Clipped sigmoid RGB of the field at metric vertices [N, 3]."""
    v = torch.from_numpy(np.asarray(verts_metric, np.float32))
    return torch.cat([torch.clamp(torch.sigmoid(field_query(
        mapper.params, normalize_world(v[s:s + chunk].to(mapper.device),
                                       mapper.spec),
        mapper.spec)[:, :3]), 0.0, 1.0)
        for s in range(0, v.shape[0], chunk)]).cpu().numpy()


def extract_mesh(mapper, voxel_size: float = 0.05,
                 bound: Optional[np.ndarray] = None,
                 isolevel: float = 0.0,
                 color_mode: str = "color"):
    """Returns (verts [N,3] metric, faces [M,3], colors [N,3] float or None).

    color_mode: 'color' (field RGB), 'uncert' (jet-colormapped uncertainty),
    'none'.
    """
    bound = (np.asarray(bound, dtype=np.float32) if bound is not None
             else np.asarray(mapper.cfg.mapper.marching_cubes_bound,
                             dtype=np.float32))
    # each stage returns host arrays: its section holds its device work
    with mapper._t("mesh_field_query"):
        sdf, uncert, (tx, ty, tz) = _dense_sdf(mapper, bound, voxel_size)
    with mapper._t("mesh_marching_tets"):
        verts_vox, faces = marching_cubes(sdf, isolevel, MC_TRUNCATION)
    if len(verts_vox) == 0:
        return verts_vox, faces, None
    # voxel -> metric: the grid axes are uniform linspaces
    steps = np.array([tx[1] - tx[0] if len(tx) > 1 else 1.0,
                      ty[1] - ty[0] if len(ty) > 1 else 1.0,
                      tz[1] - tz[0] if len(tz) > 1 else 1.0])
    origin = np.array([tx[0], ty[0], tz[0]])
    verts = (verts_vox * steps + origin).astype(np.float32)

    colors = None
    if color_mode == "color":
        with mapper._t("mesh_colors"):
            colors = _query_colors(mapper, verts)
    elif color_mode == "uncert":
        from naruto_tpu_torch.visualization.raster import jet

        # softplus + floor, jet colormap — ref coslam_utils.py:186-205
        uv = trilinear_interpolation_np(np.log1p(np.exp(uncert)) + 0.01,
                                        verts_vox).astype(np.float32)
        lo, hi = uv.min(), uv.max()
        norm = (uv - lo) / (hi - lo + 1e-9)
        colors = jet(norm).astype(np.float32)
    return verts, faces, colors


def save_mesh(mapper, path: str, voxel_size: float = 0.05,
              color_mode: str = "color",
              bound: Optional[np.ndarray] = None) -> str:
    verts, faces, colors = extract_mesh(mapper, voxel_size, bound,
                                        color_mode=color_mode)
    write_ply(path, verts, faces, colors)
    return path
