"""The port's frame prefetcher (naruto_tpu_torch/sim/prefetch.py) against
naruto_tpu's on one host simulator, and the port's passive engine runs
that use it (replay and raycast) against the same runs with their frames
made inline. The JAX engine never runs here."""
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from naruto_tpu.sim.prefetch import FramePrefetcher as JFramePrefetcher
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.scripts.make_scene_assets import (make_scene_mesh,
                                                        write_scene_mesh)
from naruto_tpu_torch.sim import init_simulator, scripted
from naruto_tpu_torch.sim.base import quantize_color
from naruto_tpu_torch.sim.prefetch import FramePrefetcher
from naruto_tpu_torch.sim.raycast import RaycastSimulator
from naruto_tpu_torch.sim.replay import ReplaySimulator
from naruto_tpu_torch.system import engine as tengine
from naruto_tpu_torch.system.engine import Engine
from naruto_tpu_torch.system.pose_loader import load_traj_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_DIR = os.path.join(ROOT, "data", "traj_ab")
TRAJ = os.path.join(TRAJ_DIR, "traj.txt")


# ------------------------------------------------ the prefetcher vs JAX's
class HostSim:
    """A frame source on the host: frame k is drawn from the seed k (float
    colour beyond [0, 1] on both sides, so quantizing clips) with the
    pose's x added to the depth. Logs every update_step and render."""

    def __init__(self, h=6, w=8, fail_at=None):
        self.device = torch.device("cpu")
        self.h, self.w = h, w
        self.fail_at = fail_at
        self.step = 0
        self.calls = []

    def update_step(self, step):
        self.calls.append(("update_step", step))
        self.step = step

    def _float(self, c2w):
        self.calls.append(("render", self.step))
        if self.step == self.fail_at:
            raise RuntimeError(f"no frame at step {self.step}")
        rng = np.random.default_rng(self.step)
        color = rng.uniform(-0.1, 1.1, (self.h, self.w, 3)).astype(
            np.float32)
        depth = rng.uniform(0.1, 3.0, (self.h, self.w)).astype(np.float32)
        return color, depth + np.float32(c2w[0, 3])

    def simulate(self, c2w):
        """The JAX prefetcher's call."""
        return self._float(c2w)

    def host_frame(self, c2w, quantize=True):
        """The port's."""
        color, depth = self._float(c2w)
        return (quantize_color(color) if quantize else color), depth


def _traj(n):
    out = []
    for k in range(n):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.25 * k
        out.append(c2w)
    return out


def cadence(i):
    """needs_frame at map_every = keyframe_every = 5, no tracking."""
    return i == 0 or i % 5 == 0


CASES = {
    # a visualizer saves every raw frame: all made, colour float
    "needs_none": (None, 12, 12),
    # the passive protocol's cadence
    "cadence_5_5": (cadence, 20, 20),
    # tracking consumes every frame
    "tracking": (lambda i: True, 12, 12),
    # a run shorter than its trajectory
    "short_horizon": (cadence, 12, 20),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefetcher_matches_jax(case):
    """The same update_step and render calls in the same order, and the
    same frame per step (dtype included), as naruto_tpu's prefetcher
    over the steps of a run."""
    needs, horizon, n_traj = CASES[case]
    traj = _traj(n_traj)
    logs, frames = [], []
    for cls in (JFramePrefetcher, FramePrefetcher):
        sim = HostSim()
        pf = cls(sim, lambda s: traj[s], needs_fn=needs, horizon=horizon)
        got = [pf.get(i) for i in range(horizon)]
        pf._pool.shutdown(wait=True)    # the JAX close() does not wait
        pf.close()
        logs.append(sim.calls)
        frames.append([tuple(None if x is None else np.asarray(x)
                             for x in fr) for fr in got])
    assert logs[1] == logs[0]
    want_needed = [i for i in range(horizon) if needs is None or needs(i)]
    assert [s for c, s in logs[1] if c == "render"] == want_needed
    for i, (t, j) in enumerate(zip(*frames[::-1])):
        if j[0] is None:
            assert t == (None, None), i
            continue
        for a, b in zip(t, j):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert t[0].dtype == (np.float32 if needs is None else np.uint8)


def test_prefetcher_out_of_order_and_repeat():
    """A step asked for out of order loads on the caller's thread after the
    frame in flight; the frame it gives is that step's; the last frame
    asked again is the one delivered (the JAX module's semantics)."""
    traj = _traj(20)
    sim, ref = HostSim(), HostSim()
    pf = FramePrefetcher(sim, lambda s: traj[s], needs_fn=cadence,
                         horizon=20)
    for step in (0, 10, 15, 15, 5):
        color, depth = pf.get(step)
        ref.update_step(step)
        want = ref.host_frame(traj[step])
        np.testing.assert_array_equal(color.numpy(), want[0])
        np.testing.assert_array_equal(depth.numpy(), want[1])
    assert pf.get(3) == (None, None)
    pf.close()
    # each in-flight load ran whole, before the caller's own
    renders = [s for c, s in sim.calls if c == "render"]
    assert renders == [0, 5, 10, 15, 5, 10]
    for (c1, s1), (c2, s2) in zip(sim.calls[::2], sim.calls[1::2]):
        assert (c1, c2) == ("update_step", "render") and s1 == s2


def test_prefetcher_worker_error_reraises():
    """A frame that fails in the worker fails the get of its step, not
    before and not silently."""
    traj = _traj(20)
    pf = FramePrefetcher(HostSim(fail_at=10), lambda s: traj[s],
                         needs_fn=cadence, horizon=20)
    for i in range(10):
        pf.get(i)
    with pytest.raises(RuntimeError, match="no frame at step 10"):
        pf.get(10)
    pf.close()


# ----------------------------------------------------- passive engine runs
N_STEPS = 40
# tests/test_torch_engine.py::PASSIVE_40, the 24x32 passive protocol
PASSIVE_40 = {
    "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
            "cy": 11.5, "far": 3.0},
    "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32),
            "scene_path": TRAJ_DIR},
    "grid": {"hash_size": 12},
    "mapper": {"sample": 64, "iters": 2, "first_iters": 8,
               "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
    "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8},
    "mesh": {"voxel_final": 0.1, "voxel_eval": 0.1},
}
TRACKING = {"tracking_enable": True, "track_sample": 64,
            "track_ignore_edge_w": 2, "track_ignore_edge_h": 2}


def passive_cfg(tmp, num_iter=N_STEPS, over=None):
    cfg = make_config("Replica", "office0", num_iter=num_iter, overrides={
        **PASSIVE_40, "general": {"result_dir": str(tmp), "seed": 0}})
    cfg = cfg.replace(enable_active_planning=False)
    return deep_update(cfg, over) if over else cfg


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """The trajectory's first N_STEPS frames captured from the analytic
    room at 24x32 (tests/test_torch_replay.py's pattern)."""
    cap = tmp_path_factory.mktemp("capture")
    cfg = passive_cfg(cap / "unused")
    poses = load_traj_file(TRAJ, "Replica")[:N_STEPS]
    scripted.run_scripted_simulation(init_simulator(cfg, "cpu"), poses,
                                     str(cap))
    return cap


@pytest.fixture(scope="module")
def raycast_scene(tmp_path_factory):
    """A scene directory: office0's mesh at 0.1 m as mesh.ply beside the
    trajectory's traj.txt."""
    scene = tmp_path_factory.mktemp("office0_mesh")
    write_scene_mesh(str(scene / "mesh.ply"),
                     *make_scene_mesh("Replica", "office0", 0.1,
                                      device="cpu"))
    shutil.copyfile(TRAJ, scene / "traj.txt")
    return scene


class Inline:
    """The simulator with host_frame hidden: the engine then makes every
    frame inline on its own thread (sim.frame / sim.simulate)."""

    def __init__(self, sim):
        self._sim = sim

    def __getattr__(self, name):
        if name == "host_frame":
            raise AttributeError(name)
        return getattr(self._sim, name)


def _engine(cfg, inline: bool):
    """An engine whose simulator logs the step of each frame it makes
    and, per thread, the steps it is stepped to."""
    eng = Engine(cfg, device="cpu", quiet=True)
    sim = eng.sim
    renders, stepped = [], {"main": [], "worker": []}
    host_frame, update_step = sim.host_frame, sim.update_step

    def counted(c2w, quantize=True):
        renders.append(sim.step)
        return host_frame(c2w, quantize)

    def logged(step):
        main = threading.current_thread() is threading.main_thread()
        stepped["main" if main else "worker"].append(step)
        update_step(step)

    sim.host_frame, sim.update_step = counted, logged
    if inline:
        eng.sim = Inline(sim)
    return eng, renders, stepped


def _run_both(cfg_fn, sim_type):
    """The run prefetched, then inline; returns both engines, their
    renders and their simulators' steps by thread."""
    out = []
    for inline in (False, True):
        eng, renders, stepped = _engine(cfg_fn(inline), inline)
        assert isinstance(eng.sim if not inline else eng.sim._sim, sim_type)
        made = []
        orig = tengine.FramePrefetcher
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tengine, "FramePrefetcher",
                       lambda *a, **kw: made.append(orig(*a, **kw))
                       or made[-1])
            eng.run()
        assert len(made) == (0 if inline else 1)
        out.append((eng, renders, stepped))
    return out


def _assert_same_run(a, b):
    assert torch.equal(a.mapper.poses, b.mapper.poses)
    pa, pb = a.mapper._all_params(), b.mapper._all_params()
    assert len(pa) == len(pb)
    for x, y in zip(pa, pb):
        assert torch.equal(x, y)


def test_passive_replay_prefetched_equals_inline(tmp_path, capture):
    """The passive protocol over a replayed capture: the prefetched run's
    poses and field equal the inline run's bit for bit, and it decodes
    only the frames the mapper consumes (at most one more)."""
    def cfg(inline):
        return passive_cfg(tmp_path / str(inline), over={
            "sim": {"method": "replay", "scene_path": str(capture)}})

    (pre, r_pre, s_pre), (inl, r_inl, s_inl) = _run_both(cfg,
                                                         ReplaySimulator)
    _assert_same_run(pre, inl)
    needed = [i for i in range(N_STEPS) if pre.mapper.needs_frame(i)]
    assert len(needed) < N_STEPS
    assert r_inl == needed
    assert len(r_pre) <= len(needed) + 1 and r_pre == needed
    # prefetched, the loop never steps the simulator: the worker does,
    # to each frame's step (step 0's frame is loaded on the caller's
    # thread); inline, the loop steps it every step
    assert s_pre == {"main": [0], "worker": needed[1:]}
    assert s_inl == {"main": list(range(N_STEPS)), "worker": []}
    np.testing.assert_array_equal(
        pre.mapper.poses[:N_STEPS].numpy(),
        np.stack(load_traj_file(str(capture / "traj.txt"), "Replica")))
    assert len(pre.timer.timings["Simulation"]) == len(needed)


def test_passive_raycast_prefetched_equals_inline(tmp_path, raycast_scene):
    """The passive protocol over office0's mesh with one moving object and
    tracking on (every frame consumed, the poses the tracker's): the
    prefetched run's poses and field equal the inline run's bit for
    bit; the worker steps the object's physics as the engine would."""
    n = 20
    traj = load_traj_file(TRAJ, "Replica")
    front = traj[0][:3, 3] + traj[0][:3, 2] * 1.0
    sphere = {"template": "sphere:0.25", "location": front.tolist(),
              "velocity": [0.3, 0.0, 0.0]}

    def cfg(inline):
        return passive_cfg(tmp_path / str(inline), num_iter=n, over={
            "sim": {"method": "raycast", "scene_path": str(raycast_scene),
                    "objects": [sphere], "physics_dt": 0.1},
            "mapper": TRACKING, "start_c2w": None})

    (pre, r_pre, _), (inl, r_inl, _) = _run_both(cfg, RaycastSimulator)
    _assert_same_run(pre, inl)
    assert r_pre == r_inl == list(range(n))
    sim = pre.sim
    assert sim._physics_step == n - 1
    np.testing.assert_array_equal(sim._obj_states[0]["pos"],
                                  inl.sim._sim._obj_states[0]["pos"])
    # the object is in view and moves between frames
    sim.update_step(0)
    assert float(sim.host_frame(traj[0])[1].min()) < 0.9


def test_worker_error_fails_the_run(tmp_path, capture):
    """A simulator that raises at step k fails run() with its error, and
    the prefetcher is closed."""
    closed = []

    class Closing(FramePrefetcher):
        def close(self):
            super().close()
            closed.append(True)

    eng = Engine(passive_cfg(tmp_path, num_iter=12, over={
        "sim": {"method": "replay", "scene_path": str(capture)}}),
        device="cpu", quiet=True)
    sim = eng.sim
    host_frame = sim.host_frame

    def failing(c2w, quantize=True):
        if sim.step == 10:
            raise OSError("frame 10 is unreadable")
        return host_frame(c2w, quantize)

    sim.host_frame = failing
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "FramePrefetcher", Closing)
        with pytest.raises(OSError, match="frame 10 is unreadable"):
            eng.run()
    assert closed == [True]
    # steps 0-9 mapped; step 10 failed at its frame
    assert len(eng.timer.timings["SLAM"]) == 10


def test_saver_gets_a_float_frame_every_step(tmp_path, capture):
    """With the rgbd panel on, the prefetcher makes every frame in float:
    the saver gets each step's, equal to the simulator's simulate(); the
    mapper gets the uint8 frame on the steps that consume one."""
    n = 7
    eng = Engine(passive_cfg(tmp_path, num_iter=n, over={
        "sim": {"method": "replay", "scene_path": str(capture)},
        "vis": {"enable_all_vis": True, "save_rgbd": True}}),
        device="cpu", quiet=True)
    seen, fed = [], []
    eng.visualizer.main = lambda mapper, planner, color, depth, c2w: \
        seen.append((color, depth))
    recon = eng.mapper.online_recon_step

    def recorded(i, color, depth, c2w):
        fed.append((i, None if color is None else color.dtype))
        return recon(i, color, depth, c2w)

    eng.mapper.online_recon_step = recorded
    eng.run()
    assert len(seen) == n
    ref = ReplaySimulator(eng.cfg, "cpu")
    for i, (color, depth) in enumerate(seen):
        assert color.dtype == torch.float32
        ref.update_step(i)
        want = ref.simulate(None)
        assert torch.equal(color, want[0]) and torch.equal(depth, want[1])
    assert fed == [(i, torch.uint8 if eng.mapper.needs_frame(i) else None)
                   for i in range(n)]
