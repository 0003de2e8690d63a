"""Mean Absolute SDF Distance (MAD) evaluation (the port's own copy of
naruto_tpu/evaluation/mad.py; `mapper` is the port's Mapper: its
`predict_sdf` and its loss weights `lw`).

Protocol parity with src/evaluation/eval_mad.py:76-97: sample 200k points on
the ground-truth mesh surface with seed 0, query the trained field's SDF at
those points, MAD = mean(|sdf|) * trunc * 100 cm.

Note on units: the field predicts SDF in truncation units (supervised via
z + sdf*trunc ~ depth); the reference multiplies |sdf| by 10 — exactly
trunc(0.1m) * 100 cm/m — to report centimeters.
"""
from __future__ import annotations

import numpy as np

from naruto_tpu_torch.evaluation.recon import sample_surface_points


def eval_mad(mapper, gt_verts: np.ndarray, gt_faces: np.ndarray,
             n_samples: int = 200_000, seed: int = 0) -> float:
    pts = sample_surface_points(gt_verts, gt_faces, n_samples, seed)
    sdf = mapper.predict_sdf(pts)
    trunc = mapper.lw.trunc * mapper.lw.sc_factor
    return float(np.abs(sdf).mean() * trunc * 100.0)
