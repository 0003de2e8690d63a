"""Reconstruction metrics: accuracy / completion / completion ratio (the
port's own copy of naruto_tpu/evaluation/recon.py).

Protocol parity with the reference eval pipeline (src/evaluation/
eval_recon.py + neural_slam_eval's calc_3d_mesh_metric — SURVEY.md C29a):
  * sample 200k points on each mesh surface (area-weighted triangle
    sampling);
  * accuracy  = mean distance from reconstructed samples to the GT surface
    samples (cm);
  * completion = mean distance from GT samples to reconstructed samples (cm);
  * completion ratio = % of GT samples within 5 cm;
  * optional ICP alignment of the reconstructed mesh before comparison.
Nearest neighbors via cKDTree (the reference uses sklearn KDTree).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial import cKDTree


def sample_surface_points(verts: np.ndarray, faces: np.ndarray, n: int,
                          seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling."""
    rng = np.random.default_rng(seed)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = areas.sum()
    if total <= 0 or len(faces) == 0:
        return verts[rng.integers(0, max(len(verts), 1), size=n)]
    probs = areas / total
    tri = rng.choice(len(faces), size=n, p=probs)
    u = rng.uniform(size=(n, 1))
    v = rng.uniform(size=(n, 1))
    flip = (u + v) > 1.0
    u = np.where(flip, 1.0 - u, u)
    v = np.where(flip, 1.0 - v, v)
    return (v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
            ).astype(np.float32)


def nearest_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, workers=-1)
    return d


def icp_align(src_pts: np.ndarray, dst_pts: np.ndarray,
              iters: int = 20) -> np.ndarray:
    """Rigid point-to-point ICP; returns a 4x4 transform src -> dst
    (the reference optionally aligns via open3d ICP)."""
    T = np.eye(4)
    src = src_pts.copy()
    tree = cKDTree(dst_pts)
    for _ in range(iters):
        _, idx = tree.query(src, k=1, workers=-1)
        tgt = dst_pts[idx]
        mu_s, mu_t = src.mean(0), tgt.mean(0)
        H = (src - mu_s).T @ (tgt - mu_t)
        U, _, Vt = np.linalg.svd(H)
        R = Vt.T @ U.T
        if np.linalg.det(R) < 0:
            Vt[-1] *= -1
            R = Vt.T @ U.T
        t = mu_t - R @ mu_s
        src = src @ R.T + t
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
    return T


def eval_mesh(rec_verts: np.ndarray, rec_faces: np.ndarray,
              gt_verts: np.ndarray, gt_faces: np.ndarray,
              n_samples: int = 200_000, threshold_cm: float = 5.0,
              align: bool = False, seed: int = 0) -> Dict[str, float]:
    """Returns accuracy (cm), completion (cm), completion ratio (%)."""
    rec_pts = sample_surface_points(rec_verts, rec_faces, n_samples, seed)
    gt_pts = sample_surface_points(gt_verts, gt_faces, n_samples, seed + 1)
    if align and len(rec_pts) and len(gt_pts):
        T = icp_align(rec_pts[::20], gt_pts[::20])
        rec_pts = rec_pts @ T[:3, :3].T + T[:3, 3]
    acc_d = nearest_distances(rec_pts, gt_pts)
    acc = acc_d.mean() * 100.0
    comp_d = nearest_distances(gt_pts, rec_pts)
    comp = comp_d.mean() * 100.0
    ratio = float((comp_d * 100.0 < threshold_cm).mean() * 100.0)
    # F-score@threshold (beyond the reference's metric set, standard in
    # recon papers): harmonic mean of precision (rec->gt within t) and
    # recall (gt->rec within t) over the same distance arrays
    prec = float((acc_d * 100.0 < threshold_cm).mean())
    rec = ratio / 100.0
    fscore = 2 * prec * rec / (prec + rec) if (prec + rec) > 0 else 0.0
    return {"accuracy_cm": float(acc), "completion_cm": float(comp),
            "completion_ratio_pct": ratio,
            "fscore_pct": float(fscore * 100.0)}
