"""The numbers that decide ``correct``: the program's checked mapping calls
against the plain reference's, on the same weights, frames and draws.

* ``first_loss_gap``: the largest |program - reference| / |reference| of
  the first iteration's loss terms (colour, depth, SDF, free space,
  uncertainty, smoothness) and their sum: the frame, the sampling, the
  selection, the field forward, the render and the loss at the initial
  weights, before any step has moved them. A term each: a lower
  precision moves each, and their errors can cancel in the sum.
* ``loss_gap``: the largest such gap of the loss over every iteration of
  the checked calls.
* ``moment_gap``: after the first checked call, per parameter leaf, the
  gap between the norms of the program's and the reference's first Adam
  moment (the gradients as the optimizer took them), over the larger of
  the reference leaf's norm and the median leaf's; the worst leaf.
* ``change_gap``: after the last checked call, the same gap between the
  norms of each leaf's change from the initial weights. Leaves whose
  reference moment is under a thousandth of the median leaf's are left
  out: their gradient is nought to rounding and they move by round-off.

Where both sides' observations carry ``volumes`` (the map volumes the
planner reads: the set-up query at the initial weights, then the volumes
after each checked call, as (sdf, uncertainty) host tensors), also:

* ``volume_sdf_gap``: the worst, over the volumes, of the norm of the
  SDF's difference over the reference SDF's norm, over every voxel;
* ``volume_band_gap``: the worst share of voxels inside the surface band
  (``reference.SURFACE_BAND``, where the uncertainty volume is nonzero) in
  one volume and outside it in the other;
* ``volume_uncert_gap``: the worst norm of the uncertainty's difference
  on the voxels both place in the band, over the reference's norm there;
* ``volume_first_gap``: the larger of the set-up volume's SDF and
  uncertainty gaps: the volume query at the initial weights, before any
  step.

A gap of norms for the leaves, not the norm of a difference: the table's
first Adam steps move each entry by the learning rate on the sign of its
gradient, and an entry whose gradient is nought to rounding takes either
sign in two summation orders. The volumes take the norm of the
difference over all their voxels: after training, the entries that such
a sign moves (eps 1e-15 makes it a full step) shift the SDF and the
uncertainty of the few voxels that read them by a large share of the
largest value, so a largest difference is as large on a sound run as on
a broken one, while a volume a step late departs by about its own norm.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from reference import SURFACE_BAND

QUIET_LEAF = 1e-3


def _norms(leaves) -> List[float]:
    return [float(t.double().norm()) for t in leaves]


def _worst(prog: List[float], ref: List[float],
           keep: Optional[List[bool]] = None) -> float:
    keep = keep or [True] * len(ref)
    kept = [r for r, k in zip(ref, keep) if k]
    med = statistics.median(kept)
    return max((abs(p - r) / max(r, med, 1e-30)
                for p, r, k in zip(prog, ref, keep) if k), default=0.0)


def _gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """`losses`: checked calls of iterations of {term: value}, the
    mapper's loss terms and their weighted sum "total"."""
    lp = [x["total"] for c in prog["losses"] for x in c]
    lr = [x["total"] for c in ref["losses"] for x in c]
    if len(lp) != len(lr):
        raise ValueError(f"{len(lp)} program losses, {len(lr)} reference")
    loss = max(_gap(a, b) for a, b in zip(lp, lr))
    if not all(math.isfinite(a) for a in lp):
        loss = math.inf
    m_prog, m_ref = _norms(prog["moments"]), _norms(ref["moments"])
    med = statistics.median(m_ref)
    keep = [r >= QUIET_LEAF * med for r in m_ref]
    d_prog = _norms([p - i for p, i in zip(prog["params"], prog["init"])])
    d_ref = _norms([p - i for p, i in zip(ref["params"], prog["init"])])
    tp, tr = prog["losses"][0][0], ref["losses"][0][0]
    first = max(_gap(tp[k], tr[k]) for k in tr if k in tp)
    out = {"first_loss_gap": first, "loss_gap": loss,
           "moment_gap": _worst(m_prog, m_ref),
           "change_gap": _worst(d_prog, d_ref, keep)}
    per = volume_gaps(prog, ref)
    out.update({k: max(v) for k, v in per.items()})
    if per:
        out["volume_first_gap"] = max(per["volume_sdf_gap"][0],
                                      per["volume_uncert_gap"][0])
    return out


def _band(sdf: torch.Tensor) -> torch.Tensor:
    return (sdf >= SURFACE_BAND[0]) & (sdf < SURFACE_BAND[1])


def _rel_norm(diff: torch.Tensor, ref: torch.Tensor) -> float:
    """|diff| over |ref| (2-norms); inf where diff holds a non-finite
    value."""
    if not bool(torch.isfinite(diff).all()):
        return math.inf
    return float(diff.norm()) / max(float(ref.norm()), 1e-30)


def volume_gaps(prog: Dict, ref: Dict) -> Dict[str, List[float]]:
    """The three volume numbers of each volume (see above); empty where
    either side carries no volumes."""
    if "volumes" not in prog or "volumes" not in ref:
        return {}
    vp, vr = prog["volumes"], ref["volumes"]
    if len(vp) != len(vr):
        raise ValueError(f"{len(vp)} program volumes, {len(vr)} reference")
    out: Dict[str, List[float]] = {"volume_sdf_gap": [],
                                   "volume_band_gap": [],
                                   "volume_uncert_gap": []}
    for (sp, up), (sr, ur) in zip(vp, vr):
        sp, up, sr, ur = (t.double() for t in (sp, up, sr, ur))
        bp, br = _band(sp), _band(sr)
        both = bp & br
        out["volume_sdf_gap"].append(_rel_norm(sp - sr, sr))
        out["volume_band_gap"].append(
            float((bp != br).double().mean())
            if bool(torch.isfinite(sp).all()) else math.inf)
        out["volume_uncert_gap"].append(_rel_norm((up - ur)[both],
                                                  ur[both]))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell compares (its limits file names it) is finite
    and within its limit."""
    return all(math.isfinite(numbers[k]) and numbers[k] <= v
               for k, v in limits.items())


def detail(prog: Dict, ref: Dict) -> Dict[str, list]:
    """Per checked call, the largest loss gap, and the first iteration's;
    per leaf, the moment and change gaps; per volume, the volume numbers
    (``volumes_*_gap``; for setting limits)."""
    calls = [max(_gap(a["total"], b["total"]) for a, b in zip(cp, cr))
             for cp, cr in zip(prog["losses"], ref["losses"])]
    tp, tr = prog["losses"][0][0], ref["losses"][0][0]
    first = {k: _gap(tp[k], tr[k]) for k in tr if k in tp}
    m_prog, m_ref = _norms(prog["moments"]), _norms(ref["moments"])
    med = statistics.median(m_ref)
    d_prog = _norms([p - i for p, i in zip(prog["params"], prog["init"])])
    d_ref = _norms([p - i for p, i in zip(ref["params"], prog["init"])])
    dmed = statistics.median(d_ref)
    per = volume_gaps(prog, ref)
    return {"call_loss_gaps": calls, "first_term_gaps": first,
            "leaf_moment_gaps": [abs(p - r) / max(r, med, 1e-30)
                                 for p, r in zip(m_prog, m_ref)],
            "leaf_change_gaps": [abs(p - r) / max(r, dmed, 1e-30)
                                 for p, r in zip(d_prog, d_ref)],
            "leaf_moment_norms": m_ref,
            **{k.replace("volume_", "volumes_"): v for k, v in per.items()}}
