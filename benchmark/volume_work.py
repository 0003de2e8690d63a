"""The work of a map-volume query, counted from the configuration's shapes
as ``work.py`` counts a BA iteration's: what the algorithm needs, a lower
bound of what any implementation moves.

Per voxel of the planner's grid (``mapper.voxel_size`` over the bound):

* FLOPs: the SDF MLP forward (2 per multiply-add), the hash grid's
  trilinear blend on every level (8 corner weights of two products each,
  8F multiply-adds) and the uncertainty grid's (the same with F = 1).
  The hash itself, the one-blob encoding and the softplus are left out.
* Bytes: the point read (3 floats), the SDF and the uncertainty written
  (2 floats); the hash table (in its gather dtype) and the uncertainty
  grid read once each.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from reference import Grid, param_shapes, volume_shape


def voxels(cfg: dict) -> int:
    m = cfg["mapper"]
    return int(np.prod(volume_shape(m["bound"], m["voxel_size"])))


def volume_query_work(cfg: dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one query of the map volumes."""
    g = Grid(cfg)
    shapes = param_shapes(cfg)
    n_sdf = cfg["decoder"]["num_layers"]
    macs = sum(a * b for a, b in shapes["decoder"][:n_sdf])
    per_voxel = 2 * macs + g.L * (16 + 2 * 8 * g.F) + (16 + 2 * 8)
    n = voxels(cfg)
    table = sum(int(np.prod(s)) for s in shapes["table"])
    grid = int(np.prod(shapes["uncert"][0]))
    nbytes = n * (3 + 2) * 4 + table * g.dtype.itemsize + grid * 4
    return float(n * per_voxel), float(nbytes)
