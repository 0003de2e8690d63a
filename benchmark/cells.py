"""What every kind of traffic shares, and the loader of the kinds.

A traffic file names its kind (``"kind"``); the kind is the class ``Cell``
of ``benchmark/kinds/<kind>.py``, a subclass of ``cells.Cell`` found by
that name, so a later kind is a new file. A kind's cell:

* ``setup()`` builds the program, runs the checked calls and keeps in
  ``obs`` what the comparison reads: the losses of the checked calls, the
  first moments of every parameter after the first one, the parameters
  after the last, and the initial weights; where its unit queries the map
  volumes, also ``volumes``: the (sdf, uncertainty) host copies of the
  set-up query and of each checked call's;
* ``unit()`` runs one unit of the window's work (through ``_timed``) and
  adds what it completed to ``work``, counted in ``units`` (``"iters"``:
  BA iterations, which ``map_iters_per_s`` reads in any kind);
* ``begin_window()`` and ``readings()`` (optional) mark its own state as
  the window opens and return what its metric readers read beside the
  window's clock;
* ``free()`` drops the program; ``reference(control)`` makes the same
  ``obs`` from the plain reference (``reference.py``), on the same frames,
  weights and draw-site seeds.
"""
from __future__ import annotations

import importlib.util
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

import inputs
import reference as plain
import scene

GROUPS = ("table", "decoder", "uncert")
# the draw sites the reference draws from (the mapper's, by name)
SITES = ("global_rays", "current_rays", "z_noise", "smoothness",
         "keyframe_scores")


def kind(name: str, root: str):
    """The cell class of benchmark/kinds/<name>.py under `root`."""
    path = os.path.join(root, "benchmark", "kinds", name + ".py")
    spec = importlib.util.spec_from_file_location("kind_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Cell


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def host(tensors) -> List[torch.Tensor]:
    return [t.detach().to("cpu", torch.float32, copy=True) for t in tensors]


def program_leaves(mapper) -> List[torch.Tensor]:
    p = mapper.params
    t = p["table"]
    table = [t["hash"], *t["dense"]] if isinstance(t, dict) else [t]
    return table + [*p["sdf_mlp"], *p["color_mlp"]] + [p["uncert_grid"]]


def program_moments(mapper) -> List[torch.Tensor]:
    return (list(mapper.embed_opt.mu) + list(mapper.decoder_opt.exp_avg)
            + list(mapper.uncert_opt.exp_avg))


def ref_flat(state: Dict[str, List[torch.Tensor]], suffix: str = ""):
    return [t for g in GROUPS for t in state[g + suffix]]


def terms(auxes) -> List[Dict[str, torch.Tensor]]:
    """Each iteration's loss terms, copied (a graph replay rewrites
    them)."""
    return [{k: v.detach().clone() for k, v in a.items()} for a in auxes]


def floats(calls) -> List[List[Dict[str, float]]]:
    return [[{k: float(v) for k, v in it.items()} for it in c]
            for c in calls]


def port_config(cfg: dict, over: Optional[dict] = None):
    """The program's config: its preset for the dataset and scene, then
    every value of the configuration file, then `over`."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.config.schema import deep_update

    g = cfg["general"]
    out = deep_update(make_config(g["dataset"], g["scene"]), cfg)
    return deep_update(out, over) if over else out


def merged(cfg: dict, over: Optional[dict]) -> dict:
    """The configuration dict with the traffic's overrides merged in."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = v
    return out


# --------------------------------------------------------------- faults
def fault_state(mapper) -> None:
    """A mapping call that leaves the field and its optimizers as they
    were."""
    mapper._apply_map_update = lambda *a, **k: None
    mapper._apply_uncert_update = lambda *a, **k: None
    mapper._accum_uncert = lambda *a, **k: None


def fault_half(mapper) -> None:
    """Every other ray of every batch left out, the loss a mean over the
    rest."""
    inner = mapper._grad_fn

    def half(rays_o, rays_d, rgb, depth, mask, z_noise, *a, **k):
        if k.get("importance_u") is not None:
            k["importance_u"] = k["importance_u"][::2]
        return inner(rays_o[::2], rays_d[::2], rgb[::2], depth[::2],
                     mask[::2], z_noise[::2], *a, **k)

    mapper._grad_fn = half


def fault_stale(mapper) -> None:
    """The map volumes one mapping step late: each volume query hands out
    what the query before it computed, so the planner (and the next call's
    active-ray selection) reads the previous step's volumes."""
    inner = mapper._volumes_impl
    last: List = []

    def late():
        now = inner()
        out = last[0] if last else now
        last[:] = [now]
        return out

    mapper._volumes_impl = late


FAULTS = {"state": fault_state, "half": fault_half, "stale": fault_stale}


# ----------------------------------------------------------------- base
class Cell:
    """The configuration, the traffic, the seed, the device, the window's
    counters and the observations."""

    units = "units"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 root: str, tmp: str, fault: Optional[str] = None):
        self.cfg = merged(cfg, traffic.get("config"))
        self.traffic, self.seed = traffic, int(seed)
        self.dev = torch.device(device)
        self.root, self.tmp, self.fault = root, tmp, fault
        self.traj = scene.load_trajectory(
            os.path.join(root, traffic["trajectory"]))
        if "shift" in traffic:
            # metres added to every pose's translation, to place the
            # recorded path inside another scene's room
            for p in self.traj:
                p[:3, 3] += np.asarray(traffic["shift"], np.float32)
        self.work = 0                # units of work done in the window
        self.unit_s: List[float] = []
        self.events: Optional[list] = None   # CUDA event pairs per unit
        self.obs: Dict = {}
        self.setup_marks: List = []  # (set-up stage, perf_counter at its end)

    def mark(self, stage: str) -> None:
        self.setup_marks.append((stage, time.perf_counter()))

    def room(self) -> scene.BoxRoom:
        c, ph = self.cfg["cam"], self.cfg["sim"]["pinhole_hw"]
        return scene.BoxRoom(self.cfg["mapper"]["bound"],
                             dict(c, H=ph[0], W=ph[1]), self.dev)

    def pose(self, i: int) -> torch.Tensor:
        return torch.as_tensor(self.traj[i], device=self.dev)

    def begin_window(self) -> None:
        pass

    def readings(self) -> Dict:
        return {}

    def _timed(self, fn):
        """fn() timed as one unit of the window."""
        if self.events is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        t0 = time.perf_counter()
        out = fn()
        self.unit_s.append(time.perf_counter() - t0)
        if self.events is not None:
            e1.record()
            self.events.append((e0, e1))
        return out

    def unit_device_ms(self) -> List[float]:
        return [a.elapsed_time(b) for a, b in (self.events or [])]

    def reference_state(self, control: bool):
        plain.set_precision(control)
        leaves = inputs.weights(self.cfg, self.seed, self.dev)
        gens = inputs.generators(self.seed, SITES, self.dev)
        init = ref_flat({k: host(v) for k, v in leaves.items()})
        return leaves, gens, init
