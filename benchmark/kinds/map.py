"""The ``map`` kind: BA calls back to back on a keyframe database.

Set-up builds the program's ``Mapper`` with the benchmark's weights and
reseeded draw sites, renders the frames of the traffic's keyframe poses
(``scene.py``), adds them as keyframes, computes the map volumes once,
then makes the checked calls: ``Mapper._ba_impl`` at the bucket its
keyframe count picks, the window's own call on the same frame (the first
one warms every bucket up and captures this one's graph). A unit of the
window is one more such call, ``iters`` BA iterations.
"""
from __future__ import annotations

import gc
from typing import Dict, List

import torch

import cells
import inputs
import reference as plain


class Cell(cells.Cell):
    units = "iters"

    def setup(self) -> None:
        from naruto_tpu_torch.mapping.mapper import Mapper

        t = self.traffic
        pcfg = cells.port_config(self.cfg)
        self.mapper = m = Mapper(pcfg, device=self.dev)
        leaves = inputs.weights(self.cfg, self.seed, self.dev)
        m.load_weights(inputs.program_tree(self.cfg, leaves))
        self.obs["init"] = cells.ref_flat(
            {k: cells.host(v) for k, v in leaves.items()})
        del leaves
        inputs.reseed(m.gens, self.seed)
        if self.fault:
            cells.FAULTS[self.fault](m)
        self.mark("program")
        room = self.room()
        for fid in self.keyframe_ids():
            m.poses[fid] = self.pose(fid)
            m.add_keyframe(m.frame_to_rays(*room.frame(self.traj[fid])), fid)
        cur = t["current"]
        self.frame_rays = m.frame_to_rays(*room.frame(self.traj[cur]))
        self.c2w = self.pose(cur)
        cells.sync(self.dev)
        self.mark("keyframes")
        self.query()
        self.bucket = m._pick_bucket(m.kf.count)
        self.iters = pcfg.mapper.iters
        losses = []
        for j in range(t["checked_calls"]):
            losses.append(cells.terms(self.call()))
            if j == 0:
                self.obs["moments"] = cells.host(cells.program_moments(m))
            cells.sync(self.dev)
            self.mark(f"call{j + 1}")
        self.obs["params"] = cells.host(cells.program_leaves(m))
        self.obs["losses"] = cells.floats(losses)
        cells.sync(self.dev)

    def keyframe_ids(self) -> List[int]:
        k = self.traffic["keyframes"]
        return [k["first"] + k["every"] * i for i in range(k["count"])]

    def query(self) -> None:
        """The map volumes, as set-up computes them once."""
        self.mapper.map_volumes()

    def call(self) -> List[Dict]:
        """One unit's work: a BA call; each iteration's loss terms."""
        return self.mapper._ba_impl(self.bucket, self.frame_rays, self.c2w,
                                    self.traffic["current"])

    def unit(self) -> None:
        self._timed(self.call)
        self.work += self.iters

    def readings(self) -> Dict:
        return {"bucket": self.bucket, "iters": self.iters}

    def free(self) -> None:
        del self.mapper, self.frame_rays
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, control: bool = False) -> Dict:
        leaves, gens, init = self.reference_state(control)
        ids = self.keyframe_ids()
        cur = self.traffic["current"]
        r = plain.Mapping(self.cfg, leaves, gens, self.dev,
                          n_poses=max(ids + [cur]) + 1, kf_slots=len(ids),
                          control=control)
        room = self.room()
        for fid in ids:
            r.poses[fid] = self.pose(fid)
            r.add_keyframe(r.frame_rays(*room.frame(self.traj[fid])))
        rays = r.frame_rays(*room.frame(self.traj[cur]))
        out = {"losses": [], "init": init}
        self.ref_query(r, out)
        for j in range(self.traffic["checked_calls"]):
            out["losses"].append(self.ref_call(r, rays, self.pose(cur), cur,
                                               out))
            if j == 0:
                out["moments"] = cells.ref_flat(r.state(), ".m")
        out["params"] = cells.ref_flat(r.state())
        return out

    def ref_query(self, r: plain.Mapping, out: Dict) -> None:
        """The reference's counterpart of query()."""
        r.volumes()

    def ref_call(self, r: plain.Mapping, rays, c2w, cur: int,
                 out: Dict) -> List[Dict[str, float]]:
        """The reference's counterpart of call()."""
        return r.ba(r.bucket(), rays, c2w, cur)
