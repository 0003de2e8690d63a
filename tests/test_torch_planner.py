"""The port's planner (naruto_tpu_torch/planner/, geometry/pose.py,
geometry/voxel.py) against naruto_tpu's on identical inputs, with the JAX
package's aggregation draws passed in; and the planner's own contracts
(tests/test_planner.py's) on the port."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.config.schema import deep_update as jdeep_update
from naruto_tpu.geometry import pose as jpose
from naruto_tpu.geometry import voxel as jvoxel
from naruto_tpu.planner import init_planner as jinit_planner
from naruto_tpu.planner.aggregation import make_aggregator as jmake_aggregator
from naruto_tpu.planner.aggregation import make_goal_space as jmake_goal_space
from naruto_tpu.planner.collision import is_collision_free as jcollision_free
from naruto_tpu.planner.rotation import rotation_planning as jrotation_planning
from naruto_tpu.planner.rrt import RRTPlanner as JRRTPlanner
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.geometry import pose, voxel
from naruto_tpu_torch.planner import NarutoPlanner, init_planner
from naruto_tpu_torch.ops import unit_linspace
from naruto_tpu_torch.planner.aggregation import Aggregator, make_goal_space
from naruto_tpu_torch.planner.collision import (is_collision_free,
                                                query_sdf_np)
from naruto_tpu_torch.planner.rotation import rotation_planning
from naruto_tpu_torch.planner.rrt import RRTPlanner

torch.set_num_threads(1)

GS_RTOL = 1e-6      # gs_aggre: the same terms, summed in another order


def box_room_sdf(shape=(30, 30, 20), wall=3):
    """SDF (voxel units): distance to nearest wall; interior positive."""
    X, Y, Z = shape
    x, y, z = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                          indexing="ij")
    return np.minimum.reduce([
        x - wall, X - 1 - wall - x, y - wall, Y - 1 - wall - y,
        z - wall, Z - 1 - wall - z]).astype(np.float32)


def two_room_sdf(door: bool) -> np.ndarray:
    """tests/test_planner.py::TestRRT's two rooms split by a wall at x=20,
    with an optional door (y 18..22); free space 5, walls -1."""
    sdf = np.full((40, 40, 10), 5.0, dtype=np.float32)
    sdf[0, :, :] = sdf[-1, :, :] = -1.0
    sdf[:, 0, :] = sdf[:, -1, :] = -1.0
    sdf[:, :, 0] = sdf[:, :, -1] = -1.0
    sdf[20, :, :] = -1.0
    if door:
        sdf[20, 18:23, 1:9] = 5.0
    return sdf


# -------------------------------------------------------------- copies
@pytest.mark.parametrize("case", ["random", "vertical_down", "vertical_up",
                                  "up_y"])
def test_lookat_rotation_matches_jax(case):
    """Bit for bit, including the degenerate-vertical epsilon tilt."""
    rng = np.random.default_rng(0)
    up = np.array([0.0, 1.0, 0.0]) if case == "up_y" else \
        np.array([0.0, 0.0, 1.0])
    if case.startswith("vertical"):
        eye = np.array([0.3, -1.2, 0.5])
        pairs = [(eye, eye + [0.0, 0.0, -1.0 if case == "vertical_down"
                              else 1.0])]
    else:
        pairs = [(rng.normal(size=3), rng.normal(size=3)) for _ in range(50)]
    for eye, target in pairs:
        got = pose.lookat_rotation(eye, target, up)
        np.testing.assert_array_equal(
            got, jpose.lookat_rotation(eye, target, up))
        assert got.dtype == np.float32 and np.isfinite(got).all()


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(1)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = Rotation.random(random_state=2).as_matrix()
    c2w[:3, 3] = rng.normal(size=3)
    c2w2 = c2w.copy()
    c2w2[:3, 3] += 0.5
    for name in ("rdf_to_rub", "rub_to_rdf", "replica_traj_to_rdf",
                 "coslam_replica2habitat", "coslam_mp3d2habitat"):
        np.testing.assert_array_equal(getattr(pose, name)(c2w),
                                      getattr(jpose, name)(c2w))
    for method in ("coslam_replica2habitat", "coslam_mp3d2habitat",
                   "coslam_naruto2habitat"):
        np.testing.assert_array_equal(
            pose.habitat_pose_conversion(c2w, method),
            jpose.habitat_pose_conversion(c2w, method))
    d = rng.normal(size=(7, 3)).astype(np.float32)
    for a, b in zip(pose.transform_rays(d, c2w),
                    jpose.transform_rays(d, c2w)):
        np.testing.assert_array_equal(a, b)
    assert pose.pose_distance(c2w, c2w2) == jpose.pose_distance(c2w, c2w2)


def test_voxel_helpers_match_jax():
    bound = np.asarray([[-2.2, 2.6], [-3.4, 2.1], [-1.4, 2.0]], np.float32)
    rng = np.random.default_rng(3)
    vox = rng.uniform(0, 40, (100, 3))
    loc = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
    np.testing.assert_array_equal(voxel.vox2loc(vox, bound, 0.1),
                                  jvoxel.vox2loc(vox, bound, 0.1))
    np.testing.assert_array_equal(voxel.loc2vox(loc, bound, 0.1),
                                  jvoxel.loc2vox(loc, bound, 0.1))
    np.testing.assert_array_equal(voxel.normalize_points(loc, bound),
                                  jvoxel.normalize_points(loc, bound))
    assert voxel.volume_shape(bound, 0.1) == jvoxel.volume_shape(bound, 0.1)


COLLISION_CASES = {
    # tests/test_planner.py::TestCollision's segments, then random ones
    "free line": ([10.0, 10, 10], [20.0, 20, 10], {}),
    "blocked line": ([15.0, 15, 10], [0.0, 15, 10], {}),
    "prefix count": ([15.0, 15, 10], [2.0, 15, 10], {"step_size": 1}),
}


@pytest.mark.parametrize("case", [*COLLISION_CASES, "random"])
def test_is_collision_free_matches_jax(case):
    sdf = box_room_sdf()
    if case == "random":
        rng = np.random.default_rng(4)
        segs = [(rng.uniform(0, 29, 3), rng.uniform(0, 29, 3),
                 {"step_size": float(rng.choice([0.5, 1.0, 2.0])),
                  "collision_thre": float(rng.choice([0.5, 1.5]))})
                for _ in range(200)]
    else:
        segs = [COLLISION_CASES[case]]
    for pa, pb, kw in segs:
        got = is_collision_free(np.asarray(pa), np.asarray(pb), sdf, **kw)
        assert got == jcollision_free(np.asarray(pa), np.asarray(pb), sdf,
                                      **kw)
    if case == "blocked line":
        assert not got[1]


def test_query_sdf_exact_at_vertices():
    vol = np.random.default_rng(0).normal(size=(5, 5, 5)).astype(np.float32)
    out = query_sdf_np(vol, np.array([[1.0, 2.0, 3.0], [4.0, 4.0, 4.0]]))
    np.testing.assert_array_equal(out, [vol[1, 2, 3], vol[4, 4, 4]])


@pytest.mark.parametrize("case", ["step cap", "greedy order", "lookats"])
def test_rotation_planning_matches_jax(case):
    R0 = np.eye(3)
    if case == "step cap":
        targets = [Rotation.from_euler("z", 45, degrees=True).as_matrix()]
    elif case == "greedy order":
        targets = [Rotation.from_euler("z", a, degrees=True).as_matrix()
                   for a in (170, 20)]
    else:
        R0 = pose.lookat_rotation([0.0, 0, 0], [1.0, 0.2, 0.1])
        rng = np.random.default_rng(5)
        targets = [pose.lookat_rotation([0.0, 0, 0], rng.normal(size=3))
                   for _ in range(6)]
    got = rotation_planning(R0, targets, 10.0)
    want = jrotation_planning(R0, targets, 10.0)
    assert len(got) == len(want) > len(targets)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _rrt_pair(shape, seed, **kw):
    return (RRTPlanner(shape, rng=np.random.default_rng(seed), **kw),
            JRRTPlanner(shape, rng=np.random.default_rng(seed), **kw))


def _same_tree(a, b):
    assert a.n_nodes == b.n_nodes and a.goal_parent == b.goal_parent
    assert a.rrt_iter == b.rrt_iter
    np.testing.assert_array_equal(a.nodes[:a.n_nodes], b.nodes[:b.n_nodes])
    np.testing.assert_array_equal(a.parents[:a.n_nodes],
                                  b.parents[:b.n_nodes])
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


@pytest.mark.parametrize("case", ["open room", "unreachable goal",
                                  "no direct line"])
def test_rrt_run_and_path_match_jax(case):
    """The same seed and SDF grow the same tree: nodes, parents, the
    path, and the rng's state after it."""
    sdf = box_room_sdf()
    kw = {"step_size": 1.0, "step_amplifier": 10}
    start, goal = np.array([10.0, 10, 10]), np.array([20.0, 20, 12])
    if case == "unreachable goal":
        kw["max_iter"] = 200
        start, goal = np.array([15.0, 15, 10]), np.array([1.0, 1.0, 1.0])
    if case == "no direct line":
        kw["enable_direct_line"] = False
    ours, ref = _rrt_pair(sdf.shape, 0, **kw)
    for rrt in (ours, ref):
        rrt.start_new_plan(start, goal, sdf)
    reached = ours.run()
    assert reached == ref.run() == (case != "unreachable goal")
    _same_tree(ours, ref)
    got, want = ours.find_path(), ref.find_path()
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["box room", "two rooms, door",
                                  "two rooms, sealed"])
def test_rrt_reachable_mask_matches_jax(case):
    """run_full's dense growth and get_reachable_mask, bit for bit (the
    non-trivial two-room maps of TestRRT::
    test_run_full_mask_equivalence_nontrivial)."""
    if case == "box room":
        sdf, start, seed = box_room_sdf(), np.array([15.0, 15, 10]), 0
    else:
        sdf, start, seed = two_room_sdf(case.endswith("door")), \
            np.array([10.0, 20, 5]), 3
    ours, ref = _rrt_pair(sdf.shape, seed, step_size=1.0, step_amplifier=10,
                          full_iters=3000)
    for rrt in (ours, ref):
        rrt.start_new_plan(start, np.zeros(3), sdf)
        rrt.run_full()
    _same_tree(ours, ref)
    mask = ours.get_reachable_mask()
    np.testing.assert_array_equal(mask, ref.get_reachable_mask())
    assert mask.dtype == np.float32 and mask[tuple(start.astype(int))] == 1.0
    if case == "two rooms, sealed":
        assert mask[22:39, 1:39, 1:9].max() == 0.0


# ----------------------------------------------------------- aggregation
def test_march_params_are_jax_linspace():
    """The march's parameters (and the importance sampler's evenly spaced
    draws): jnp.linspace(0, 1, n) bit for bit."""
    for n in (1, 2, 7, 12, 30, 31):
        np.testing.assert_array_equal(unit_linspace(n),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def jax_subset_draw(uncert, key, k_eff, subset_eff, weighted):
    """The draw of naruto_tpu/planner/aggregation.py's aggregate, outside
    it: the indices into the top-k that it picks with `key`."""
    top_vals, _ = jax.lax.top_k(uncert.reshape(-1), k_eff)
    if weighted:
        nz = (top_vals > 0).astype(jnp.float32)
        p = jnp.where(jnp.sum(nz) >= subset_eff, nz,
                      jnp.ones_like(nz)) + 1e-9
        return jax.random.choice(key, k_eff, (subset_eff,), replace=False,
                                 p=p / jnp.sum(p))
    return jax.random.choice(key, k_eff, (subset_eff,), replace=False)


def _blobs(shape, rng, n, nonzero_frac=1.0):
    """Uncertainty on random surface-like blobs of voxels."""
    u = np.zeros(shape, np.float32)
    for _ in range(n):
        c = [rng.integers(4, s - 4) for s in shape]
        u[c[0] - 1:c[0] + 2, c[1] - 1:c[1] + 2, c[2] - 1:c[2] + 2] = \
            rng.uniform(0.05, 5.0, (3, 3, 3))
    if nonzero_frac < 1.0:
        u *= rng.uniform(size=shape) < nonzero_frac
    return u


AGG_CASES = {
    # name: (shape, n blobs, top_k, subset, goal_chunk, sdf obstacles)
    "blobs": ((30, 30, 20), 12, 400, 100, 2048, False),
    "ties (fewer nonzeros than top_k)": ((20, 20, 12), 2, 300, 300, 2048,
                                         False),
    "goal chunks smaller than G": ((30, 30, 20), 12, 400, 100, 64, False),
    "march across obstacles": ((30, 30, 20), 16, 500, 200, 2048, True),
}


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("case", list(AGG_CASES))
def test_aggregation_matches_jax(case, weighted):
    """naruto_tpu's jitted aggregator and the port's on the same volumes
    and the same draw: topk_vxl, collections and any_valid exact, gs_aggre
    within GS_RTOL; the argmax goal equal where the top two differ by more
    than that."""
    shape, n_blobs, top_k, subset, chunk, obstacles = AGG_CASES[case]
    rng = np.random.default_rng(6)
    sdf = box_room_sdf(shape)
    if obstacles:
        # thin walls and pillars: whether a target is visible depends on
        # which voxels the march's truncated points land in
        sdf[14, 5:25, :] = -1.0
        sdf[14, 12:15, 6:12] = 2.0
        sdf[rng.integers(4, 26, 40), rng.integers(4, 26, 40), :] = -0.5
    uncert = _blobs(shape, rng, n_blobs)
    if case.startswith("ties"):
        assert 0 < np.count_nonzero(uncert) < top_k
    gs = make_goal_space(shape, 0.1, gs_z_levels=[6, 8, 10])
    jgs = jmake_goal_space(shape, 0.1, gs_z_levels=[6, 8, 10])
    kw = dict(top_k=top_k, subset=subset, sensing_range=(0.5, 2.0),
              safe_sdf=0.8, goal_chunk=chunk,
              subset_nonzero_weighted=weighted)
    ours = Aggregator(shape, gs, 0.1, device="cpu", **kw)
    ref = jmake_aggregator(shape, jgs, 0.1, **kw)
    if case.startswith("goal chunks"):
        assert ours.goal_pts_c.shape[0] > 1 and len(gs.points) % chunk
    key = jax.random.PRNGKey(11)
    want = ref(uncert, sdf, key)
    sel = np.asarray(jax_subset_draw(jnp.asarray(uncert), key,
                                     ours.k_eff, ours.subset_eff, weighted))
    got = ours(torch.from_numpy(uncert), torch.from_numpy(sdf),
               torch.from_numpy(np.array(sel)))

    np.testing.assert_array_equal(got.topk_vxl.numpy(),
                                  np.asarray(want.topk_vxl))
    np.testing.assert_array_equal(got.collections.numpy(),
                                  np.asarray(want.collections))
    assert bool(got.any_valid) == bool(want.any_valid)
    g, w = got.gs_aggre.numpy(), np.asarray(want.gs_aggre)
    np.testing.assert_allclose(g, w, rtol=GS_RTOL, atol=0)
    assert g.shape == gs.shape and (w > 0).sum() > 3
    top2 = np.sort(w.reshape(-1))[-2:]
    if top2[1] - top2[0] > GS_RTOL * top2[1]:
        assert g.argmax() == w.argmax()
    if case.startswith("ties"):
        # the whole top-k, ties included, in jax.lax.top_k's order
        _, idx = jax.lax.top_k(jnp.asarray(uncert).reshape(-1), top_k)
        Y, Z = shape[1:]
        idx = np.asarray(idx)[sel]
        np.testing.assert_array_equal(
            got.topk_vxl.numpy(),
            np.stack([idx // (Y * Z), (idx // Z) % Y, idx % Z], -1))


def test_aggregation_draw_is_a_subset_of_the_top_k():
    """The port's own draw: `subset` distinct indices into the top-k; the
    weighted draw lands on every nonzero entry when they are fewer than
    the subset (tests/test_planner.py::test_subset_weighting_flag)."""
    shape = (20, 20, 12)
    gs = make_goal_space(shape, 0.1, gs_z_levels=[6])
    uncert = np.zeros(shape, np.float32)
    nz = [(10, 10, 6), (11, 10, 6), (10, 11, 6), (11, 11, 6), (9, 10, 6),
          (10, 9, 6), (9, 9, 6), (11, 9, 6)]
    for v in nz:
        uncert[v] = 5.0
    chosen = {}
    for weighted in (True, False):
        agg = Aggregator(shape, gs, 0.1, top_k=400, subset=8,
                         sensing_range=(0.0, 2.0),
                         subset_nonzero_weighted=weighted, device="cpu")
        gen = torch.Generator().manual_seed(3)
        sel = []
        out = agg(torch.from_numpy(uncert),
                  torch.from_numpy(box_room_sdf(shape)),
                  lambda v: sel.append(agg.draw_subset(v, gen)) or sel[0])
        assert sorted(set(sel[0].tolist())) == sorted(sel[0].tolist())
        assert 0 <= int(sel[0].min()) and int(sel[0].max()) < 400
        chosen[weighted] = sum(uncert[tuple(v)] > 0
                               for v in out.topk_vxl.numpy())
    assert chosen[True] == 8 and chosen[False] <= 4


# ------------------------------------------------------------ the planner
BOUND = ((-1.5, 1.4), (-1.5, 1.4), (-1.0, 0.9))     # 30x30x20 at 0.1


def planner_over(**planner):
    return {"mapper": {"bound": BOUND, "marching_cubes_bound": BOUND},
            "planner": {"gs_z_levels": [8, 10, 12], **planner}}


def make_planner(sim=None, **planner):
    """The port's planner on the 30x30x20 box room; the RRT gives up on an
    unreachable goal after 300 iterations (the default, 18,000, costs
    seconds a plan)."""
    planner = {"rrt_max_iter": 300, **planner}
    cfg = make_config("Replica", "office0", num_iter=100,
                      overrides=planner_over(**planner))
    p = init_planner(cfg, device="cpu")
    p.init_data(cfg.mapper.bound_np)
    p.init_local_planner()
    if sim is not None:
        p.update_sim(sim)
    return p


def start_pose(planner):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = planner.vox2loc(np.array([15.0, 15, 10]))
    return pose


def tvols(uncert, sdf):
    return [torch.from_numpy(uncert), torch.from_numpy(sdf)]


class RecordedDraws:
    """Wraps the JAX planner's jitted aggregate: for each call, the indices
    into the top-k its key draws, which the port's planner then takes in
    place of its own."""

    def __init__(self, jplanner, pplanner):
        self.queue = []
        agg, pcfg = jplanner.aggregate, jplanner.pcfg

        def recorded(uncert, sdf, key):
            k_eff = min(pcfg.uncert_top_k, uncert.size)
            self.queue.append(np.array(jax_subset_draw(
                jnp.asarray(uncert), key, k_eff,
                min(pcfg.uncert_top_k_subset, k_eff),
                pcfg.subset_nonzero_weighted)))
            return agg(uncert, sdf, key)

        jplanner.aggregate = recorded
        pplanner._draw_subset = lambda top_vals: torch.from_numpy(
            self.queue.pop(0))


LOCKSTEP = {
    "default": {},
    "mitigations": {"goal_repeat_penalty": 1.0, "trav_mask_decay": 2,
                    "subset_nonzero_weighted": False},
}


N_LOCKSTEP = 120


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_fsm_lockstep_with_jax(case):
    """Both planners on one config and one sequence of (volumes, pose,
    is_new_vols) for N_LOCKSTEP steps, the port taking the JAX planner's
    draws: the same state every step and the same poses within 1e-6,
    through several plans, obstacles that appear on the path (collision,
    staying) and a volume with no valid goal (the traversability refilter,
    an unreachable goal)."""
    over = planner_over(rrt_max_iter=400, **LOCKSTEP[case])
    jcfg = jdeep_update(jmake_config("Replica", "office0", num_iter=100),
                        over)
    ours = init_planner(make_config("Replica", "office0", num_iter=100,
                                    overrides=over), device="cpu")
    ref = jinit_planner(jcfg)
    for p in (ours, ref):
        p.init_data(jcfg.mapper.bound_np)
        p.init_local_planner()
    draws = RecordedDraws(ref, ours)
    rng = np.random.default_rng(7)
    shape = ref.vol_shape
    room = box_room_sdf(shape)
    pose_o = pose_r = start_pose(ref)
    states = []
    for i in range(N_LOCKSTEP):
        new = i % 5 == 0
        if new:
            uncert = _blobs(shape, rng, 6)
            sdf = room.copy()
            if (ref.state == "movingToGoal" and ref.path
                    and ref.stats["collisions"] < 2):
                # an obstacle on the next path node's cell: the line check
                # collides (it is gone at the next mapping step)
                c = np.floor(ref.path[-1]).astype(int)
                sdf[c[0]:c[0] + 2, c[1]:c[1] + 2, c[2]:c[2] + 2] = -1.0
            if i >= 40 and not ref.stats["mask_refilters"]:
                # until a plan has seen it: a closed pocket around the
                # agent, with no safe goal (the traversability mask is
                # recomputed, and the goal is out of reach)
                c = np.round(ref.loc2vox(pose_r[:3, 3])).astype(int)
                sdf = np.full(shape, -1.0, np.float32)
                sdf[c[0] - 1:c[0] + 2, c[1] - 1:c[1] + 2,
                    c[2] - 1:c[2] + 2] = 2.0
        for p in (ours, ref):
            p.update_step(i)
        pose_r = ref.main([uncert, sdf], pose_r, new)
        pose_o = ours.main(tvols(uncert, sdf), pose_o, new)
        assert ours.state == ref.state, (i, ours.state, ref.state)
        assert np.abs(pose_o - pose_r).max() <= 1e-6, i
        states.append(ours.state)
    assert not draws.queue
    assert len(set(states)) == 7, set(states)
    assert ours.stats["collisions"] == ref.stats["collisions"] >= 1
    assert ours.stats["mask_refilters"] == ref.stats["mask_refilters"] >= 1
    assert ours.stats_summary()["n_unreachable"] >= 1
    np.testing.assert_array_equal(ours.traversability_mask,
                                  ref.traversability_mask)
    s_o, s_r = ours.stats_summary(), ref.stats_summary()
    for k in ("n_plans", "n_unreachable", "goal_repeat_max",
              "goal_repeat_vxl", "collisions", "mask_refilters",
              "mask_decays", "state_steps"):
        assert s_o[k] == s_r[k], k
    for a, b in zip(ours.stats["events"], ref.stats["events"]):
        assert a["goal_vxl"] == b["goal_vxl"] and a["pos_vxl"] == b["pos_vxl"]
        assert a["uncert_mass"] == pytest.approx(b["uncert_mass"], rel=1e-5)


def test_full_planning_cycle():
    """tests/test_planner.py::TestPlannerFSM on the port: the FSM goes
    through a plan, the agent moves, stays in free space, and every pose's
    rotation is proper."""
    planner = make_planner(rrt_max_iter=2000)
    assert planner.vol_shape == (30, 30, 20)
    sdf = box_room_sdf(planner.vol_shape)
    uncert = np.zeros(planner.vol_shape, dtype=np.float32)
    uncert[22, 22, 10] = 4.0
    uncert[20, 8, 10] = 3.0
    pose0 = pose = start_pose(planner)
    states = []
    for i in range(60):
        planner.update_step(i)
        pose = planner.main(tvols(uncert, sdf), pose, is_new_vols=i % 5 == 0)
        states.append(planner.state)
        R = pose[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(R) > 0.9
    assert {"planning", "movingToGoal", "rotatingAtStart"} <= set(states)
    assert np.linalg.norm(pose[:3, 3] - pose0[:3, 3]) > 0.2
    assert query_sdf_np(sdf, planner.loc2vox(pose[:3, 3])[None])[0] > 0


def _transition_setup(**planner):
    planner = make_planner(**planner)
    sdf = box_room_sdf(planner.vol_shape)
    uncert = np.zeros(planner.vol_shape, dtype=np.float32)
    uncert[21:24, 21:24, 9:12] = 4.0
    return planner, tvols(uncert, sdf), start_pose(planner)


def test_canonical_sequence():
    planner, vols, pose = _transition_setup()
    seq = []
    for i in range(40):
        planner.update_step(i)
        pose = planner.main(vols, pose, is_new_vols=(i == 0))
        seq.append(planner.state)
    collapsed = [s for j, s in enumerate(seq) if j == 0 or s != seq[j - 1]]
    assert collapsed[:6] == [
        "planning", "rotationPlanningAtStart", "rotatingAtStart",
        "movingToGoal", "rotationPlanningAtGoal", "rotatingAtGoal"]


def test_collision_on_first_move_after_rotations_empty():
    """A collision on the very step the rotation list empties lands in
    staying without moving; the next plan rebuilds rots and path."""
    planner, vols, pose = _transition_setup()
    collided = False
    for i in range(80):
        planner.update_step(i)
        prev_pos = pose[:3, 3].copy()
        if (planner.state == "movingToGoal" and not collided
                and not planner.rots and planner.path):
            vols[1] = vols[1].clone()
            nxt = np.round(planner.path[-1]).astype(int)
            lo = np.maximum(nxt - 2, 0)
            vols[1][lo[0]:nxt[0] + 3, lo[1]:nxt[1] + 3,
                    lo[2]:nxt[2] + 3] = -1.0
            collided = True
        pose = planner.main(vols, pose, is_new_vols=(i % 5 == 0))
        if collided and planner.state == "staying":
            np.testing.assert_allclose(pose[:3, 3], prev_pos, atol=1e-6)
            break
    assert collided and planner.stats["collisions"] >= 1
    vols[1] = torch.from_numpy(box_room_sdf(planner.vol_shape))
    seq = []
    for j in range(i + 1, i + 60):
        planner.update_step(j)
        pose = planner.main(vols, pose, is_new_vols=True)
        seq.append(planner.state)
    assert "movingToGoal" in seq


def test_unreachable_goal_goes_staying():
    planner, vols, pose = _transition_setup(rrt_max_iter=300)
    sdf = np.full(planner.vol_shape, -1.0, dtype=np.float32)
    sdf[13:18, 13:18, 8:13] = 2.0
    vols = [vols[0], torch.from_numpy(sdf)]
    planner.update_step(5)
    planner.main(vols, pose, is_new_vols=True)
    assert planner.state == "planning"
    planner.update_step(6)
    planner.main(vols, pose, is_new_vols=False)
    assert planner.state == "staying"
    assert planner.stats_summary()["n_unreachable"] == 1


def test_staying_waits_for_new_map():
    planner, vols, pose = _transition_setup()
    planner.update_step(0)
    planner.main(vols, pose, is_new_vols=False)
    assert planner.state == "staying"
    planner.main(vols, pose, is_new_vols=True)
    assert planner.state == "planning"


def _plan_at(planner, step, vols, pose):
    planner.update_step(step)
    planner.state = "planning"
    planner.compute_next_state_pose(pose, vols)


@pytest.mark.parametrize("decay", [0, 2])
def test_trav_mask_decay(decay):
    """planner.trav_mask_decay=k resets the traversability mask to ones
    every k-th plan; 0 keeps the reference lifecycle."""
    planner = make_planner(trav_mask_decay=decay)
    uncert = np.zeros(planner.vol_shape, dtype=np.float32)
    uncert[22, 22, 10] = 4.0
    vols, pose = tvols(uncert, box_room_sdf(planner.vol_shape)), \
        start_pose(planner)
    _plan_at(planner, 0, vols, pose)
    planner.traversability_mask = np.zeros(planner.vol_shape, np.float32)
    _plan_at(planner, 1, vols, pose)
    _plan_at(planner, 2, vols, pose)
    if decay:
        assert planner.stats_summary()["mask_decays"] >= 1
        assert planner.traversability_mask.max() == 1.0
    else:
        assert planner.stats["mask_decays"] == 0


def test_goal_repeat_penalty():
    """p=1.0 moves the argmax off the dominant goal; a move-time collision
    charges the goal a visit; p=0 tracks nothing."""
    for pen in (1.0, 0.0):
        planner = make_planner(goal_repeat_penalty=pen)
        uncert = np.zeros(planner.vol_shape, dtype=np.float32)
        uncert[22, 22, 10] = 5.0
        uncert[8, 8, 10] = 3.0
        vols, pose = tvols(uncert, box_room_sdf(planner.vol_shape)), \
            start_pose(planner)
        goals = []
        for i in range(3):
            _plan_at(planner, i, vols, pose)
            goals.append(tuple(planner.stats["events"][-1]["goal_vxl"]))
        if not pen:
            assert planner._goal_visits == {}
            continue
        assert len(set(goals)) >= 2
        gi = planner._last_goal_gi
        n = planner._goal_visits[gi]
        planner.state = "movingToGoal"
        planner.path = [np.array([0.0, 15.0, 10.0])]
        planner.update_state(vols, pose, is_new_vols=True)
        assert planner.state == "staying"
        assert planner._goal_visits[gi] == n + 1


class StubSim:
    def __init__(self, min_dist, invalid_frac=0.0):
        self.min_dist = min_dist
        self.invalid_frac = invalid_frac
        self.probes = 0

    def probe_erp_dist(self, pose):
        # a device tensor, as the port's simulators return it
        self.probes += 1
        erp = torch.full((8, 16), max(self.min_dist, 1.0))
        erp[0, 0] = self.min_dist
        n_inv = int(round(self.invalid_frac * erp.numel()))
        erp.view(-1)[1:1 + n_inv] = 1e8
        return erp


@pytest.mark.parametrize("override,min_dist,invalid,free,want,probes", [
    (0.05, 0.5, 0.0, False, False, 1),      # clear probe overrides phantom
    (0.05, 0.02, 0.0, False, True, 1),      # tight probe keeps collision
    (0.05, 0.5, 0.9, False, True, 1),       # invalid region keeps it
    (0.0, 0.5, 0.0, False, True, 0),        # default off never probes
    (0.05, 0.5, 0.0, True, False, 0),       # free SDF never probes
])
def test_collision_sim_override(override, min_dist, invalid, free, want,
                                probes):
    sim = StubSim(min_dist, invalid)
    planner = make_planner(sim=sim, collision_sim_override=override)
    sdf = box_room_sdf(planner.vol_shape) if free else \
        np.full(planner.vol_shape, -1.0, dtype=np.float32)
    pose = start_pose(planner)
    nxt = planner.vox2loc(np.array([16.0, 15, 10]))
    assert planner.detect_collision(sdf, pose, nxt) is want
    assert sim.probes == probes
    assert planner.stats_summary()["collision_overrides"] == int(
        probes == 1 and not want)


class Guard(torch.Tensor):
    """A volume that logs every torch function applied to it (and to what
    is computed from it)."""
    log = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        Guard.log.append(getattr(func, "__name__", str(func)))
        return super().__torch_function__(func, types, args, kwargs or {})


def test_rotating_states_never_touch_the_volumes():
    """The mirror of TestLazyVolumeConsumption: the rotation states run no
    operation on the volumes, so none waits on the device; planning pulls
    the SDF to the host once per volume, and the moves read that copy."""
    planner, vols, pose = _transition_setup()
    guarded = [v.as_subclass(Guard) for v in vols]
    ops_by_state, pulls_by_state = {}, {}
    for i in range(60):
        planner.update_step(i)
        Guard.log = []
        pose = planner.main(guarded, pose, is_new_vols=(i in (0, 30)))
        s = planner.state
        ops_by_state[s] = ops_by_state.get(s, 0) + len(Guard.log)
        pulls_by_state[s] = pulls_by_state.get(s, 0) + Guard.log.count(
            "cpu")
    for s in ("rotationPlanningAtStart", "rotatingAtStart",
              "rotationPlanningAtGoal", "rotatingAtGoal"):
        assert s in ops_by_state, ops_by_state
    assert all(n == 0 for s, n in ops_by_state.items()
               if s not in ("planning", "movingToGoal")), ops_by_state
    assert pulls_by_state["planning"] > 0
    # the moves' line checks read the copy the plan at step 30 pulled
    assert pulls_by_state.get("movingToGoal", 0) <= 1, pulls_by_state
    assert planner.timer.timings["volumes_wait"]


def test_planning_leaves_the_volumes_as_they_were():
    """The traversability filter is out of place: the volume handed in
    (the mapper's, which its active-ray selection reads) keeps its values
    and its storage."""
    planner, vols, pose = _transition_setup()
    planner.traversability_mask[:, :, :10] = 0.0
    before = [(v.data_ptr(), v.clone()) for v in vols]
    _plan_at(planner, 5, vols, pose)
    assert planner.stats["events"]
    for v, (ptr, vals) in zip(vols, before):
        assert v.data_ptr() == ptr and torch.equal(v, vals)


def test_init_planner_threads_the_config():
    planner = make_planner(subset_nonzero_weighted=False)
    assert isinstance(planner, NarutoPlanner)
    assert planner.aggregate.subset_nonzero_weighted is False
    assert planner.aggregate.device == torch.device("cpu")
    cfg = deep_update(planner.cfg, {"planner": {"method": "nope"}})
    with pytest.raises(ValueError, match="unknown planner"):
        init_planner(cfg, device="cpu")


def test_planner_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = make_config("Replica", "office0", overrides=planner_over())
    with pytest.raises(RuntimeError, match="CUDA"):
        NarutoPlanner(cfg)
