"""Full-state snapshots and resume in the port (Mapper.save_full_state /
load_full_state, the engine's ckpt_freq and run(resume_from=...), the
planner's export_state / restore_state, the generators' states, run
--resume) and the lazy volume view, against naruto_tpu where the two
share a format."""
import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.config.schema import deep_update as jdeep_update
from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu.planner.naruto_planner import NarutoPlanner as JPlanner
from naruto_tpu_torch import run as trun
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mapping.mapper import (GENERATORS_KEY, BADraws,
                                             LazyVolumes, Mapper)
from naruto_tpu_torch.planner.naruto_planner import NarutoPlanner
from naruto_tpu_torch.system import engine as tengine
from naruto_tpu_torch.system.engine import Engine
from naruto_tpu_torch.utils import ckpt_io
from naruto_tpu_torch.utils.seeding import (generator_states,
                                            make_generators,
                                            set_generator_states)
from naruto_tpu_torch.utils.timer import Timer

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ_DIR = os.path.join(ROOT, "data", "traj_ab")
BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))


def tiny_cfg(mk=make_config, **mapper_over):
    """tests/test_torch_mapping.py's tiny mapper config, one BA iteration
    with its uncertainty step."""
    return mk("Replica", "office0", num_iter=40, overrides={
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": 1, "first_iters": 5,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "uncert_accum_iters": 1, "bound": BOUND,
                   "marching_cubes_bound": BOUND, "voxel_size": 0.5,
                   **mapper_over},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4}})


def _frame(seed, H=24, W=32):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[:3] = 0.0
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return color, depth


def _pose(i):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.02 * i, -0.01 * i, 0.0]
    return c2w


def _drive(mapper, steps):
    """The online mapping steps `steps` on seeded frames and poses."""
    for i in steps:
        mapper.update_step(i)
        mapper.online_recon_step(i, *_frame(i), _pose(i))


def _jax_leaves(state):
    flat = jax.tree_util.tree_flatten_with_path(state._asdict())[0]
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def _port_leaves(mapper):
    return {k: ckpt_io._to_numpy(x)
            for k, x in ckpt_io.flatten_with_keys(mapper._full_state_tree())}


def _assert_leaves_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------- the format
@pytest.mark.parametrize("over", [{}, {"decoder": {"uncert_grid": False}}],
                         ids=["uncert_grid", "no_uncert_grid"])
def test_full_state_tree_is_the_jax_mapper_state(over):
    """The snapshot's tree is the JAX package's MapperState: the same
    structure string (its NamedTuple nodes included: KeyframeDB,
    EmbedAdamState, optax's ScaleByAdamState and EmptyState), the same
    leaf paths in the same order, the same shapes and dtypes (int32
    counts). The string is generated from the JAX package here."""
    mj = jmapper.Mapper(jdeep_update(tiny_cfg(jmake_config), over))
    mt = Mapper(deep_update(tiny_cfg(), over), device="cpu")
    assert ckpt_io.treedef_fingerprint(mt._full_state_tree()) == str(
        jax.tree_util.tree_structure(mj.state._asdict()))
    got, want = _port_leaves(mt), _jax_leaves(mj.state)
    assert list(got) == list(want)
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == {
        k: (v.shape, v.dtype) for k, v in want.items()}


def test_port_snapshot_loads_in_jax(tmp_path):
    """A port snapshot after a first frame, a BA step and two keyframes
    loads in naruto_tpu's load_full_state with every leaf equal, and its
    step and extra; the JAX package ignores the generators' header key and
    never sees an rng_key."""
    mt = Mapper(tiny_cfg(), device="cpu")
    _drive(mt, (0, 5))
    path = str(tmp_path / "port.pkl")
    extra = {"c2w": _pose(5).tolist(), "note": [1, 2]}
    mt.save_full_state(path, extra=extra)
    _, meta = ckpt_io.load_tree(path, mt._full_state_tree())
    assert "rng_key" not in meta and GENERATORS_KEY in meta
    mj = jmapper.Mapper(tiny_cfg(jmake_config))
    assert mj.load_full_state(path) == extra
    assert mj.step == 5 and mj._kf_count == 2
    _assert_leaves_equal(_jax_leaves(mj.state), _port_leaves(mt))


def _replay_ba_draws(key, mj, kf_count, n_valid, cur_cap):
    """The draws of the JAX _ba_impl's one iteration from its key splits
    (tests/test_torch_mapping.py's replay)."""
    m = mj.cfg.mapper
    n_os = m.sample * m.act_ray_oversample_mul
    ks = jax.random.split(jax.random.split(key, m.iters)[0], 3)
    total = max(kf_count * mj.rays_per_kf, 1)
    k_render, k_smooth = jax.random.split(ks[2])
    k1, k2, _ = jax.random.split(k_smooth, 3)
    n_rays = m.sample + cur_cap // 4

    def t(a):
        return torch.from_numpy(np.array(a))

    return BADraws(
        g_idx=t(jax.random.randint(ks[0], (n_os,), 0, total)).long(),
        cur_j=t(jax.random.randint(ks[1], (cur_cap,), 0, n_valid)).long(),
        z_noise=t(jax.random.uniform(k_render, (n_rays, mj.rc.n_samples))),
        smooth_offset=t(jax.random.uniform(k1, (3,))),
        smooth_jitter=t(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def test_jax_snapshot_loads_in_port(tmp_path):
    """A JAX snapshot (trained: a first frame, a BA step, two keyframes)
    loads in the port with every leaf equal, its step, its extra, and the
    host integers (keyframe count, Adam counts) that pick the next BA's
    bucket and bias corrections. The next BA step, with the JAX draws
    replayed, holds against the JAX step: the loss to 1e-5, every Adam
    moment to rel 1e-3 (the trained-BA tolerance of
    tests/test_torch_tracking.py: the jitted JAX reference leaves the hash
    backward's bf16 products unrounded), the counts exactly, the parameters
    by share as after any Adam step. The port's own draws, with no
    generator state in a JAX file, start from its seed."""
    mj = jmapper.Mapper(tiny_cfg(jmake_config))
    seen = {}
    loss_fn = mj._loss_fn

    def recording_loss_fn(*args, **kw):
        # traced once into the jitted BA; the callback runs every call
        out = loss_fn(*args, **kw)
        jax.debug.callback(lambda v: seen.update(loss=float(v)), out[0])
        return out

    mj._loss_fn = recording_loss_fn
    for i in (0, 5):
        mj.update_step(i)
        mj.online_recon_step(i, *_frame(i), _pose(i))
    path = str(tmp_path / "jax.pkl")
    mj.save_full_state(path, extra={"c2w": _pose(5).tolist()})
    mt = Mapper(tiny_cfg(), device="cpu")
    fresh = generator_states(mt.gens)
    assert mt.load_full_state(path) == {"c2w": _pose(5).tolist()}
    assert generator_states(mt.gens) == fresh
    assert (mt.step, mt.kf.count, mt.embed_opt.count) == (5, 2, 6)
    _assert_leaves_equal(_port_leaves(mt), _jax_leaves(mj.state))

    color, depth = _frame(10)
    fr_j, fr_t = mj.frame_to_rays(color, depth), mt.frame_to_rays(color,
                                                                 depth)
    bucket = mt._pick_bucket(mt.kf.count)
    assert bucket == mj._pick_bucket(mj._kf_count)
    key = jax.random.PRNGKey(11)
    seen.clear()
    state = mj._get_ba_jit(bucket)(mj.state, fr_j, jnp.asarray(_pose(10)),
                                   10, key)
    jax.block_until_ready(state)
    setup = mt._ba_setup(bucket, fr_t, torch.from_numpy(_pose(10)), 10)
    draws = _replay_ba_draws(key, mj, mt.kf.count, setup.n_valid, bucket)
    aux = mt._ba_impl(bucket, fr_t, torch.from_numpy(_pose(10)), 10,
                      draws=[draws])
    np.testing.assert_allclose(float(aux[0]["total"]), seen["loss"],
                               rtol=1e-5)
    want = _jax_leaves(state)
    got = _port_leaves(mt)
    m = mt.cfg.mapper
    lrs = {"table": m.lr_embed, "sdf_mlp": m.lr_decoder,
           "color_mlp": m.lr_decoder, "uncert_grid": m.lr_uncert}
    for k in want:
        if not k.startswith(("['params']", "['map_opt_state']",
                             "['uncert_opt_state']")) \
                or want[k].dtype == np.int32:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        elif k.startswith(("['map_opt_state']", "['uncert_opt_state']")):
            assert _rel_err(got[k], want[k]) < 1e-3, k
        elif k.startswith("['params']"):
            # an Adam step moves an entry by up to ~lr on m/sqrt(v); where
            # v is near eps a last-bit difference of the gradient moves it
            # otherwise (tests/test_torch_mapping.py::
            # test_post_adam_params_by_share)
            lr = lrs[k.split("'")[3]]
            diff = np.abs(got[k] - want[k])
            assert diff.max() <= 2 * lr * (1 + 1e-5), k
            assert (diff > 0.01 * lr).mean() < 0.02, k


def test_legacy_pickle_snapshot_refused(tmp_path):
    path = str(tmp_path / "old.pkl")
    with open(path, "wb") as f:
        pickle.dump({"params": {}}, f)
    with pytest.raises(ValueError, match="npz"):
        Mapper(tiny_cfg(), device="cpu").load_full_state(path)


def test_generator_states_round_trip():
    """Each draw site's next draws after set_generator_states equal those
    after the captured point; an unknown site is an error."""
    gens = make_generators(3, "cpu")
    for g in gens.values():
        torch.rand(5, generator=g)
    states = generator_states(gens)
    first = {k: torch.rand(4, generator=g) for k, g in gens.items()}
    other = make_generators(9, "cpu")
    set_generator_states(other, states)
    for k, g in other.items():
        assert torch.equal(torch.rand(4, generator=g), first[k]), k
    with pytest.raises(ValueError, match="unknown draw sites"):
        set_generator_states({"z_noise": gens["z_noise"]}, states)


def test_snapshot_restores_the_draws_and_the_next_steps(tmp_path):
    """A mapper restored from the port's snapshot continues bit for bit as
    the one that wrote it: the same draws (the generators ride the header),
    the same BA and keyframes."""
    a = Mapper(tiny_cfg(), device="cpu")
    _drive(a, (0, 5))
    path = str(tmp_path / "s.pkl")
    a.save_full_state(path)
    b = Mapper(tiny_cfg(), device="cpu")
    b.load_full_state(path)
    _drive(a, (10, 15))
    _drive(b, (10, 15))
    _assert_leaves_equal(_port_leaves(b), _port_leaves(a))


# ------------------------------------------------------ the lazy volumes
def test_lazy_volumes_match_an_eager_pull():
    """The mapping step's LazyVolumes: device tensors by index (the
    mapper's own uncertainty volume), a host copy on first read equal to an
    eager pull, timed once as volumes_wait; the next BA drains it first."""
    timer = Timer()
    m = Mapper(tiny_cfg(), device="cpu", timer=timer)
    m.update_step(0)
    vols = m.online_recon_step(0, *_frame(0), _pose(0))
    assert isinstance(vols, LazyVolumes) and len(vols) == 2
    assert vols[0] is m.uncert_vol
    u, s = vols
    eager = m.get_map_volumes()
    for i in (0, 1):
        np.testing.assert_array_equal(vols.host(i), eager[i])
        np.testing.assert_array_equal(vols.host(i), vols[i].numpy())
    assert len(timer.timings["volumes_wait"]) == 2
    assert vols.ready() is vols
    m.update_step(5)
    assert isinstance(m.online_recon_step(5, *_frame(5), _pose(5)),
                      LazyVolumes)
    assert len(timer.timings["ba_drain"]) == 1
    assert timer.groups["ba_drain"] == "Mapper"


# ------------------------------------------------------ the planner state
def _planner_pair():
    over = {"cam": {"H": 24, "W": 32}, "sim": {"pinhole_hw": (24, 32)},
            "planner": {"goal_repeat_penalty": 0.5}}
    return (NarutoPlanner(make_config("Replica", "office0", overrides=over),
                          "cpu"),
            JPlanner(jmake_config("Replica", "office0", overrides=over)))


def test_export_state_matches_jax():
    """export_state's JSON equals the JAX planner's for the same FSM and
    counters, but for agg_key (the subset draw's generator rides the
    snapshot's generator states); restore_state reads either package's."""
    pt, pj = _planner_pair()
    rng = np.random.default_rng(0)
    for p in (pt, pj):
        p.state = "movingToGoal"
        p.path = [rng.uniform(0, 40, 3) for _ in range(3)]
        p.lookat_tgts = [rng.uniform(-2, 2, 3).astype(np.float32)]
        p.rots = [np.eye(3, dtype=np.float32)]
        p.is_goal_reachable = True
        p._goal_visits = {(1, 2, 3): 2, (4, 5, 6): 1}
        p._last_goal_gi = (1, 2, 3)
        rng = np.random.default_rng(0)
    want = pj.export_state()
    assert want["fsm"].pop("agg_key") is not None
    got = pt.export_state()
    assert got == want
    fresh, _ = _planner_pair()
    fresh.restore_state(pj.export_state())
    assert fresh.export_state() == want
    assert [p.dtype for p in fresh.path] == [p.dtype for p in pt.path]
    assert list(fresh.generators()) == ["planner.planner_subset"]


# ------------------------------------------------------------- the engine
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
EVAL_SAMPLES = 20_000


def _engine_cfg(tmp, active, num_iter, ckpt_freq):
    over = {k: v for k, v in PASSIVE_40.items()}
    if active:
        over["sim"] = {"pinhole_hw": (24, 32), "erp_hw": (16, 32)}
    cfg = make_config("Replica", "office0", num_iter=num_iter, overrides={
        **over, "general": {"result_dir": str(tmp), "seed": 0,
                            "ckpt_freq": ckpt_freq}})
    return cfg.replace(enable_active_planning=active)


def _row(run_dir):
    return (run_dir / "eval_result.txt").read_text()


def _small_eval(mp):
    mp.setattr(tengine, "eval_mesh", functools.partial(
        tengine.eval_mesh, n_samples=EVAL_SAMPLES))
    mp.setattr(tengine, "eval_mad", functools.partial(
        tengine.eval_mad, n_samples=EVAL_SAMPLES))


def test_passive_resume_is_bit_identical(tmp_path, monkeypatch):
    """A 40-step passive run with ckpt_freq 20 writes its step-20 snapshot;
    a fresh Engine resumed from it runs steps 21-39 to the same poses,
    table, decoders and metric row, bit for bit."""
    _small_eval(monkeypatch)
    a = Engine(_engine_cfg(tmp_path / "a", False, 40, 20), device="cpu",
               quiet=True)
    a.run()
    a.finalize()
    snap = a.snapshot_path()
    assert snap == str(tmp_path / "a" / "Replica" / "office0" /
                       "full_state_latest.pkl") and os.path.exists(snap)
    assert len(a.timer.timings["full_state_save"]) == 1
    b = Engine(_engine_cfg(tmp_path / "b", False, 40, 20), device="cpu",
               quiet=True)
    final = b.run(resume_from=snap)
    assert b.mapper.step == 39 and len(b.timer.timings["SLAM"]) == 19
    b.finalize()
    np.testing.assert_array_equal(final, a.mapper.poses[39].numpy())
    for got, want in zip(b.mapper._all_params(), a.mapper._all_params()):
        assert torch.equal(got, want)
    assert torch.equal(b.mapper.poses, a.mapper.poses)
    assert _row(tmp_path / "b" / "Replica" / "office0") == \
        _row(tmp_path / "a" / "Replica" / "office0")


def test_active_resume_matches_until_the_rrt_draws(tmp_path, monkeypatch):
    """A 60-step active run with ckpt_freq 30; a fresh Engine resumed from
    the step-30 snapshot (pose, mapper state, generators, planner FSM)
    lays down the same poses as the unbroken run until the RRT next draws
    from its host rng, which a snapshot does not restore (as in
    tests/test_sim.py::TestFullStateResume)."""
    a = Engine(_engine_cfg(tmp_path / "a", True, 60, 30), device="cpu",
               quiet=True)
    a.run()
    b = Engine(_engine_cfg(tmp_path / "b", True, 60, 30), device="cpu",
               quiet=True)
    first_rrt = []
    for name in ("run", "run_full"):
        fn = getattr(b.planner.local_planner, name)

        def wrapped(*args, _fn=fn, **kw):
            first_rrt.append(b.planner.step)
            return _fn(*args, **kw)

        setattr(b.planner.local_planner, name, wrapped)
    b.run(resume_from=a.snapshot_path())
    assert b.mapper.step == 59
    upto = (first_rrt[0] if first_rrt else 59) + 1
    assert upto > 31
    assert torch.equal(b.mapper.poses[:upto], a.mapper.poses[:upto])
    assert b.planner.stats["state_steps"]


# ----------------------------------------------------------------- the CLI
def _tiny_yaml(tmp_path, ckpt_freq):
    import yaml

    path = tmp_path / "tiny.yaml"
    over = {**PASSIVE_40, "sim": {**PASSIVE_40["sim"],
                                  "pinhole_hw": [24, 32],
                                  "erp_hw": [16, 32]}}
    over["inherit_from"] = os.path.join(ROOT, "configs", "ab",
                                        "passive_traj_ab.yaml")
    over["general"] = {"num_iter": 12, "ckpt_freq": ckpt_freq}
    path.write_text(yaml.safe_dump(over))
    return str(path)


def test_run_cli_resume(tmp_path, capsys):
    """run --resume auto with no snapshot starts fresh and says so; with the
    snapshot the first run's ckpt_freq wrote, it resumes and ends where an
    unbroken run ends (the final checkpoint's arrays equal)."""
    cfg = _tiny_yaml(tmp_path, 5)
    base = ["--cfg", cfg, "--device", "cpu"]
    trun.main(base + ["--result_dir", str(tmp_path / "a"), "--resume",
                      "auto"])
    assert "starting fresh" in capsys.readouterr().out
    run_a = tmp_path / "a" / "Replica" / "office0"
    assert (run_a / "full_state_latest.pkl").exists()
    trun.main(base + ["--result_dir", str(tmp_path / "a"), "--resume",
                      "auto"])
    assert "starting fresh" not in capsys.readouterr().out
    with np.load(run_a / "ckpt_0012_final.pkl") as z:
        resumed = {k: z[k] for k in z.files if k.startswith("leaf:")}
    trun.main(base + ["--result_dir", str(tmp_path / "b")])
    with np.load(tmp_path / "b" / "Replica" / "office0" /
                 "ckpt_0012_final.pkl") as z:
        unbroken = {k: z[k] for k in z.files if k.startswith("leaf:")}
    assert list(resumed) == list(unbroken)
    for k in unbroken:
        np.testing.assert_array_equal(resumed[k], unbroken[k], err_msg=k)
