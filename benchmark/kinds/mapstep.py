"""The ``mapstep`` kind: mapping steps back to back, as the engine runs
one (``Mapper.online_recon_step`` on a mapping step).

Set-up is the ``map`` kind's, the set-up volume query included. A unit of
the window is one mapping step: ``Mapper._ba_impl`` at the bucket the
keyframe count picks, then the map volumes (``get_map_volumes_lazy``),
then the SDF volume's host copy, which the planner reads on the host (its
collision checks and RRT; the uncertainty volume it aggregates on the
device). ``iters`` BA iterations a unit.

The checked calls are the same unit. ``obs["volumes"]`` holds, as
(sdf, uncertainty) host float32 tensors, the set-up query at the initial
weights and each checked call's volumes; the reference
(``reference.Mapping.volumes``) gives the same after its set-up keyframes
and after each checked BA call.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

import cells
import reference as plain

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Cell(cells.kind("map", ROOT)):
    units = "iters"

    def setup(self) -> None:
        self.kept: Optional[List] = []
        super().setup()
        self.obs["volumes"], self.kept = self.kept, None

    def query(self) -> None:
        vols = self.mapper.get_map_volumes_lazy()
        sdf = vols.host(1)
        if self.kept is not None:
            self.kept.append((torch.tensor(sdf),
                              torch.tensor(vols.host(0))))

    def call(self) -> List[Dict]:
        aux = super().call()
        self.query()
        return aux

    def ref_query(self, r: plain.Mapping, out: Dict) -> None:
        sdf = r.volumes()
        out.setdefault("volumes", []).append(cells.host([sdf,
                                                         r.uncert_vol]))

    def ref_call(self, r: plain.Mapping, rays, c2w, cur: int,
                 out: Dict) -> List[Dict[str, float]]:
        aux = super().ref_call(r, rays, c2w, cur, out)
        self.ref_query(r, out)
        return aux
