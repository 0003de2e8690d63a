"""The port's raycast simulator (the C++ BVH renderer, its scene loading,
dynamic objects and rigs), the collision rule over it, and the engine on
mesh scenes, against naruto_tpu on the CPU. Both packages build their own
copy of native/raycaster.cpp with the same flags on this CPU, so frames
agree bit for bit; the card's host is another CPU, so the card is never
compared with the JAX package."""
import ctypes
import functools
import json

import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.planner.naruto_planner import NarutoPlanner as JPlanner
from naruto_tpu.sim.raycast import RaycastSimulator as JRaycast
from naruto_tpu.sim.rigs import render_rig as jrender_rig
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mesh.gltf import write_glb
from naruto_tpu_torch.planner.naruto_planner import NarutoPlanner
from naruto_tpu_torch.scripts.make_scene_assets import (make_scene_mesh,
                                                        write_scene_mesh)
from naruto_tpu_torch.sim import init_simulator
from naruto_tpu_torch.sim.base import quantize_color
from naruto_tpu_torch.sim.raycast import RaycastSimulator
from naruto_tpu_torch.sim.rigs import render_rig
from naruto_tpu_torch.system import engine as tengine
from naruto_tpu_torch.system.engine import Engine

torch.set_num_threads(1)

CAM = {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5, "cy": 11.5,
       "far": 3.0}
SIM = {"method": "raycast", "pinhole_hw": (24, 32), "erp_hw": (16, 32)}


def box_mesh(lo, hi):
    """Closed axis-aligned box (tests/test_raycast.py's helper): vertex
    colours encode position."""
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       dtype=np.float32)
    quads = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4), (2, 3, 7, 6),
             (1, 2, 6, 5), (0, 3, 7, 4)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    colors = (corners - lo) / (hi - lo)
    return corners, np.asarray(faces, np.int32), colors.astype(np.float32)


def cube_room():
    """A 5 m cube room with a box on its floor, for the NARUTO dataset's
    probe-collision rule."""
    v1, f1, c1 = box_mesh([-2.5] * 3, [2.5] * 3)
    v2, f2, c2 = box_mesh([1.0, 0.8, -2.5], [2.0, 1.8, -1.2])
    return (np.concatenate([v1, v2]), np.concatenate([f1, f2 + 8]),
            np.concatenate([c1, c2]))


def _cfgs(over, dataset="Replica", scene="office0"):
    return (make_config(dataset, scene, num_iter=10, overrides=over),
            jmake_config(dataset, scene, num_iter=10, overrides=over))


def _poses(n, seed, spread):
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = Rotation.from_euler(
            "xyz", rng.uniform(-180, 180, 3), degrees=True).as_matrix()
        c2w[:3, 3] = rng.uniform(-spread, spread, 3)
        out.append(c2w)
    return out


@pytest.fixture(scope="module")
def office0_mesh(tmp_path_factory):
    """office0's mesh at voxel 0.1 m from the port's asset script."""
    path = str(tmp_path_factory.mktemp("office0") / "mesh.ply")
    write_scene_mesh(path, *make_scene_mesh("Replica", "office0", 0.1,
                                            device="cpu"))
    return path


def _assert_frames_equal(t_sim, j_sim, c2w):
    got = t_sim.simulate(c2w, return_erp=True)
    want = j_sim.simulate(c2w, return_erp=True)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(t_sim.probe_erp_dist(c2w),
                                  j_sim.probe_erp_dist(c2w))


@pytest.mark.parametrize("scene", ["cube", "office0"])
def test_frames_match_jax_bit_for_bit(scene, office0_mesh):
    """Pinhole colour and depth, the ERP render and the ERP probe of the
    port's raycaster equal the JAX package's bit for bit, on the cube room
    (arrays) and on office0's mesh (a scene path)."""
    over = {"cam": CAM, "sim": dict(SIM)}
    if scene == "office0":
        over["sim"]["scene_path"] = office0_mesh
        t_cfg, j_cfg = _cfgs(over)
        t_sim = init_simulator(t_cfg, "cpu")
        j_sim = JRaycast(j_cfg)
        poses = _poses(3, 1, 0.8)
    else:
        t_cfg, j_cfg = _cfgs(over)
        v, f, c = cube_room()
        t_sim = RaycastSimulator(t_cfg, "cpu", verts=v, faces=f, colors=c)
        j_sim = JRaycast(j_cfg, verts=v, faces=f, colors=c)
        poses = _poses(3, 2, 1.5)
    assert isinstance(t_sim, RaycastSimulator)
    for c2w in poses:
        _assert_frames_equal(t_sim, j_sim, c2w)


def test_scalar_path_matches_packets():
    """The same BVH through the strict scalar per-lane loop renders the
    same pixels as the 8-wide SIMD packets (the build's -ffp-contract=off
    keeps the two in step)."""
    cfg = make_config("Replica", "office0", overrides={"cam": CAM,
                                                       "sim": SIM})
    v, f, c = cube_room()
    sim = RaycastSimulator(cfg, "cpu", verts=v, faces=f, colors=c)
    for c2w in _poses(2, 3, 1.5):
        out = []
        for flag in (0, 1):
            sim._lib.rc_set_force_scalar(sim._handle, ctypes.c_int(flag))
            out.append(sim.simulate(c2w, return_erp=True))
        for a, b in zip(*out):
            assert torch.equal(a, b)


def test_frame_quantizes_on_the_host_as_on_the_device():
    """frame() quantizes the colour on the host before the copy; the uint8
    values equal quantize_color of simulate()'s float colour (the analytic
    path's device quantization) and the mapper's host quantization."""
    cfg = make_config("Replica", "office0", overrides={"cam": CAM,
                                                       "sim": SIM})
    v, f, c = cube_room()
    sim = RaycastSimulator(cfg, "cpu", verts=v, faces=f, colors=c)
    for c2w in _poses(3, 4, 1.5):
        color, depth = sim.frame(c2w)
        ref_color, ref_depth = sim.simulate(c2w)
        assert color.dtype == torch.uint8
        assert torch.equal(color, quantize_color(ref_color))
        assert torch.equal(depth, ref_depth)
        host = sim.render_host(c2w)[0]
        np.testing.assert_array_equal(
            color.numpy(),
            (np.clip(host, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))


def test_render_rig_matches_jax():
    """Each skybox and stereo-ring view of render_rig equals the JAX
    package's."""
    t_cfg, j_cfg = _cfgs({"cam": CAM, "sim": SIM})
    v, f, c = cube_room()
    t_sim = RaycastSimulator(t_cfg, "cpu", verts=v, faces=f, colors=c)
    j_sim = JRaycast(j_cfg, verts=v, faces=f, colors=c)
    c2w = _poses(1, 5, 1.0)[0]
    for kw in ({"kind": "skybox"},
               {"kind": "horizontal+UpDown", "num_rot": 3,
                "stereo_baseline": 0.2}):
        got, want = render_rig(t_sim, c2w, **kw), jrender_rig(j_sim, c2w,
                                                              **kw)
        assert list(got) == list(want)
        for name in want:
            for g, w in zip(got[name], want[name]):
                np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------- dynamic objects
def _object_pair(objects, physics_dt=0.0, gravity=0.0):
    over = {"cam": {"H": 40, "W": 60, "fx": 30.0, "fy": 30.0, "cx": 29.5,
                    "cy": 19.5},
            "sim": {"method": "raycast", "pinhole_hw": (40, 60),
                    "erp_hw": (16, 32), "objects": objects,
                    "physics_dt": physics_dt, "gravity": gravity},
            "start_c2w": None}
    t_cfg, j_cfg = _cfgs(over)
    v, f, c = box_mesh([-3, -3, -3], [3, 3, 3])
    return (RaycastSimulator(t_cfg, "cpu", verts=v, faces=f, colors=c),
            JRaycast(j_cfg, verts=v, faces=f, colors=c))


def _assert_objects_equal(t_sim, j_sim):
    assert len(t_sim._obj_states) == len(j_sim._obj_states)
    for a, b in zip(t_sim._obj_states, j_sim._obj_states):
        for k in ("pos", "vel", "angvel", "rot"):
            np.testing.assert_array_equal(a[k], b[k])
    eye = np.eye(4, dtype=np.float32)
    for g, w in zip(t_sim.simulate(eye, return_erp=True),
                    j_sim.simulate(eye, return_erp=True)):
        np.testing.assert_array_equal(g.numpy(), w)


SPHERE = {"template": "sphere:0.3", "location": [0, 0, 1.5]}


@pytest.mark.parametrize("objects,physics_dt,gravity", [
    # a static occluder
    ([SPHERE], 0.0, 0.0),
    # a rotated thin box
    ([{"template": "box:0.8,0.8,0.05", "location": [0, 0, 1.5],
       "rotation": [90, 0, 1, 0]}], 0.0, 0.0),
    # gravity settling onto the floor
    ([SPHERE], 0.0, 10.0),
    # a moving, spinning object
    ([{**SPHERE, "velocity": [0.5, 0, 0], "angular_velocity": [0, 1, 0]}],
     0.2, 0.0),
], ids=["static", "rotated", "gravity", "moving"])
def test_dynamic_objects_match_jax(objects, physics_dt, gravity):
    """Spawn (the initial 1.0 s settle included) and every physics tick of
    the port's objects, and the frames they give, equal the JAX
    package's."""
    t_sim, j_sim = _object_pair(objects, physics_dt, gravity)
    _assert_objects_equal(t_sim, j_sim)
    for i in range(1, 6):
        t_sim.update_step(i)
        j_sim.update_step(i)
        _assert_objects_equal(t_sim, j_sim)


def test_update_step_once_per_index():
    """One physics tick per step index: a jump covers the indices between,
    replays are no-ops, as in the JAX package."""
    obj = [{**SPHERE, "velocity": [0.5, 0, 0]}]
    t_sim, j_sim = _object_pair(obj, physics_dt=0.2)
    x0 = float(t_sim._obj_states[0]["pos"][0])
    for i in (3, 1, 2, 3, 3, 4):
        t_sim.update_step(i)
        j_sim.update_step(i)
    assert t_sim._physics_step == j_sim._physics_step == 4
    np.testing.assert_allclose(float(t_sim._obj_states[0]["pos"][0]) - x0,
                               4 * 0.2 * 0.5, atol=1e-5)
    _assert_objects_equal(t_sim, j_sim)


@pytest.mark.parametrize("gravity,vel", [(0.0, 1.0), (10.0, 2.0)])
def test_wall_contact_matches_jax(gravity, vel):
    """Driven motion into a wall stops just short of it (and, under
    gravity, lands on the floor), as in the JAX package, bit for bit."""
    t_sim, j_sim = _object_pair([{**SPHERE, "velocity": [vel, 0, 0]}],
                                gravity=gravity)
    for _ in range(30):
        t_sim.step_physics(0.2)
        j_sim.step_physics(0.2)
    np.testing.assert_allclose(t_sim._obj_states[0]["pos"][0], 2.7,
                               atol=0.05)
    _assert_objects_equal(t_sim, j_sim)


# ------------------------------------------------------ simulator factory
def test_init_simulator_backends(tmp_path):
    """raycast builds the port's RaycastSimulator; replay builds the port's
    ReplaySimulator and keeps the JAX package's config-time guard; an
    unknown method is a ValueError."""
    v, f, c = cube_room()
    path = str(tmp_path / "room.glb")
    write_glb(path, v, f, colors=c)
    cfg = make_config("Replica", "office0", overrides={
        "cam": CAM, "sim": {**SIM, "scene_path": path}})
    sim = init_simulator(cfg, "cpu")
    assert isinstance(sim, RaycastSimulator)
    assert (sim.n_verts, sim.n_faces) == (16, 24)
    from naruto_tpu_torch.sim.replay import ReplaySimulator

    replay = deep_update(cfg, {"sim": {"method": "replay",
                                       "scene_path": str(tmp_path)}})
    sim = init_simulator(replay, "cpu")
    assert isinstance(sim, ReplaySimulator)
    assert sim.results_dir == str(tmp_path)       # no results/ inside
    mp3d = deep_update(make_config("MP3D", "pLe4wQe7qrG", num_iter=10),
                       {"sim": {"method": "replay"}})
    assert mp3d.enable_active_planning
    with pytest.raises(ValueError, match="ERP"):
        init_simulator(mp3d, "cpu")
    with pytest.raises(ValueError, match="unknown simulator"):
        init_simulator(deep_update(cfg, {"sim": {"method": "nope"}}), "cpu")


def test_raycast_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = make_config("Replica", "office0", overrides={"cam": CAM,
                                                       "sim": SIM})
    v, f, c = cube_room()
    with pytest.raises(RuntimeError, match="CUDA"):
        RaycastSimulator(cfg, verts=v, faces=f, colors=c)


# -------------------------------------------------------- collision rule
@pytest.mark.parametrize("dataset,scene", [("NARUTO", "hokage_room"),
                                           ("MP3D", "pLe4wQe7qrG"),
                                           ("Replica", "office0")])
def test_detect_collision_matches_jax(dataset, scene):
    """detect_collision over a raycast simulator (the ERP probes of the
    MP3D and NARUTO rules, the SDF line check of all) gives the JAX
    planner's verdict and probe count at fixed poses."""
    over = {"cam": CAM, "sim": {**SIM, "probe_hw": (16, 32)},
            "mapper": {"bound": ((-2.6, 2.6),) * 3,
                       "marching_cubes_bound": ((-2.6, 2.6),) * 3}}
    t_cfg, j_cfg = _cfgs(over, dataset, scene)
    v, f, c = cube_room()
    pt, pj = NarutoPlanner(t_cfg, "cpu"), JPlanner(j_cfg)
    pt.update_sim(RaycastSimulator(t_cfg, "cpu", verts=v, faces=f,
                                   colors=c))
    pj.update_sim(JRaycast(j_cfg, verts=v, faces=f, colors=c))
    for p in (pt, pj):
        p.init_data(t_cfg.mapper.bound_np)
    rng = np.random.default_rng(6)
    sdf = rng.uniform(-0.5, 3.0, pt.vol_shape).astype(np.float32)
    sdf[:, :, :20] = 3.0
    verdicts = []
    for c2w in _poses(6, 7, 1.5):
        nxt = c2w[:3, 3] + rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        got = pt.detect_collision(sdf, c2w, nxt)
        assert got == pj.detect_collision(sdf, c2w, nxt)
        verdicts.append(got)
    for key in ("n_probes", "collision_overrides"):
        assert pt.stats.get(key, 0) == pj.stats.get(key, 0)
    assert (pt.stats.get("n_probes", 0) > 0) == (dataset != "Replica")


# ------------------------------------------------------------ engine runs
EVAL_SAMPLES = 20_000
SMALL = {"grid": {"hash_size": 12},
         "mapper": {"sample": 64, "iters": 2, "first_iters": 8,
                    "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
         "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8},
         "mesh": {"voxel_final": 0.1, "voxel_eval": 0.1}}
# The NARUTO dataset's rules (probe collisions) on the cube room, at office
# size: hokage_room's preset with the mapping AABB cut to the room and the
# probe at the ERP's size, started at the room's centre.
ROOM_OVER = {"mapper": {**SMALL["mapper"], "bound": ((-2.6, 2.6),) * 3,
                        "marching_cubes_bound": ((-2.6, 2.6),) * 3},
             "start_c2w": ((1.0, 0.0, 0.0, 0.0), (0.0, 0.0, -1.0, 0.0),
                           (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))}
# Floors calibrated once against the JAX engine on the same configs, seed
# 0 and 20,000 eval samples (run outside tier-1), as in
# tests/test_torch_engine.py: office0 raycast acc 27.49 cm, comp 27.83 cm,
# ratio 13.61%, MAD 2.21 cm; the cube room acc 14.23, comp 21.92, ratio
# 15.13%, MAD 2.18 cm with 8 probes. Each floor sits ~30-40% beyond those
# values: the two packages draw from other generators, so the rows differ,
# but a broken loss, sampler or frame halves the ratio or multiplies the
# MAD.
FLOORS = {
    "office0": {"completion_ratio_pct": 8.5, "mad_cm": 3.0,
                "completion_cm": 37.0, "accuracy_cm": 38.0},
    "room": {"completion_ratio_pct": 9.5, "mad_cm": 3.0,
             "completion_cm": 29.0, "accuracy_cm": 20.0},
}


def _row(path):
    header, values = path.read_text().strip().splitlines()[-2:]
    return dict(zip(header.split(","), map(float, values.split(","))))


@pytest.mark.parametrize("case", ["office0", "room"])
def test_raycast_active_run_metric_floors(case, tmp_path, office0_mesh):
    """The active loop on a mesh scene through the raycast simulator, 40
    steps at 24x32 on the host: office0's mesh (a .ply) under the Replica
    rule, and the cube room (a .glb) under the NARUTO dataset's probe rule.
    The ground truth is the scene_path mesh; the row clears its floors."""
    if case == "office0":
        scene_path = office0_mesh
        cfg = make_config("Replica", "office0", num_iter=40, overrides={
            "cam": CAM, "sim": {**SIM, "scene_path": scene_path}, **SMALL,
            "general": {"result_dir": str(tmp_path), "seed": 0}})
    else:
        scene_path = str(tmp_path / "room.glb")
        v, f, c = cube_room()
        write_glb(scene_path, v, f, colors=c)
        cfg = make_config("NARUTO", "hokage_room", num_iter=40, overrides={
            "cam": CAM, "sim": {**SIM, "scene_path": scene_path,
                                "probe_hw": (16, 32)},
            **SMALL, **ROOM_OVER,
            "general": {"result_dir": str(tmp_path), "seed": 0}})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tengine, "eval_mesh", functools.partial(
            tengine.eval_mesh, n_samples=EVAL_SAMPLES))
        mp.setattr(tengine, "eval_mad", functools.partial(
            tengine.eval_mad, n_samples=EVAL_SAMPLES))
        eng = Engine(cfg, device="cpu", quiet=True)
        assert isinstance(eng.sim, RaycastSimulator)
        eng.run()
        eng.finalize()
    run_dir = tmp_path / cfg.general.dataset / cfg.general.scene
    m = _row(run_dir / "eval_result.txt")
    floors = FLOORS[case]
    assert m["completion_ratio_pct"] > floors["completion_ratio_pct"], m
    assert m["mad_cm"] < floors["mad_cm"], m
    assert m["completion_cm"] < floors["completion_cm"], m
    assert m["accuracy_cm"] < floors["accuracy_cm"], m
    assert not (run_dir / "gt_mesh.ply").exists()
    stats = json.loads((run_dir / "planner_stats.json").read_text())
    assert stats["summary"]["n_plans"] >= 1
    assert (stats["summary"]["n_probes"] > 0) == (case == "room")
