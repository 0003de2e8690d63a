"""The dense volume query and the first plan's aggregation across packages:
the JAX engine's first-frame mapping at the 24x32 office0 size of
tests/test_torch_engine.py, its field carried into the port with
Mapper.load_weights, then both packages' _volumes_impl and both planners'
first _aggregate (and the traversability refilter after it) on their own
volumes, the port taking the JAX planner's subset draws."""
import jax
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.system.engine import Engine as JEngine
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.system.engine import Engine

from test_torch_engine import ACTIVE_40, N_STEPS
from test_torch_planner import RecordedDraws

torch.set_num_threads(1)

# tests/test_parallel.py's volume tolerance (the sharded query against the
# unsharded one); the two packages' forward passes agree within it
RTOL, ATOL = 1e-5, 1e-6
# the on-surface band of _volumes_impl
SURFACE = (0.0, 0.5)


@pytest.fixture(scope="module")
def step0(tmp_path_factory):
    """Both engines on one config; the JAX one after its step-0 mapping,
    the port's mapper holding the JAX field."""
    over = {**ACTIVE_40, "general": {
        "result_dir": str(tmp_path_factory.mktemp("volumes")), "seed": 0}}
    ref = JEngine(jmake_config("Replica", "office0", num_iter=N_STEPS,
                               overrides=over), quiet=True)
    ours = Engine(make_config("Replica", "office0", num_iter=N_STEPS,
                              overrides=over), device="cpu", quiet=True)
    c2w = ref._init_pose()
    np.testing.assert_array_equal(c2w, ours._init_pose())
    for mod in (ref.sim, ref.mapper, ref.planner, ours.planner):
        mod.update_step(0)
    color, depth = ref.sim.simulate(c2w)[:2]
    ref.mapper.online_recon_step(0, color, depth, c2w)
    ours.mapper.load_weights(jax.tree_util.tree_map(
        np.asarray, ref.mapper.state.params))
    want = [np.asarray(v) for v in ref.mapper._vol_jit(
        ref.mapper.state.params)]
    got = [v.numpy() for v in ours.mapper._volumes_impl()]
    return ref, ours, c2w, want, got


def test_volumes_match_jax(step0):
    """uncert_map and sdf within RTOL/ATOL; the on-surface mask equal but
    at voxels whose sdf lies within that tolerance of a band edge."""
    _, ours, _, (u_j, s_j), (u_t, s_t) = step0
    assert u_t.shape == s_t.shape == tuple(ours.mapper.vol_shape)
    np.testing.assert_allclose(s_t, s_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(u_t, u_j, rtol=RTOL, atol=ATOL)

    def band(s):
        return (s >= SURFACE[0]) & (s < SURFACE[1])

    near_edge = np.zeros(s_j.shape, bool)
    for edge in SURFACE:
        near_edge |= np.abs(s_j - edge) <= ATOL + RTOL * abs(edge)
    differ = band(s_t) != band(s_j)
    assert not (differ & ~near_edge).any()
    # the band holds a real share of the volume (a surface was mapped)
    assert 0.01 < band(s_j).mean() < 0.9


def test_first_plan_matches_jax(step0):
    """The first plan's aggregation on the step-0 volumes: the same
    validity and masked uncertainty mass; then the traversability mask of
    the refilter, the mass under it and the second aggregation's
    validity, each as the JAX planner's."""
    ref, ours, c2w, (u_j, s_j), (u_t, s_t) = step0
    jp, tp = ref.planner, ours.planner
    RecordedDraws(jp, tp)
    for p in (jp, tp):
        p.traversability_mask = np.ones(p.vol_shape, np.float32)
    uj = u_j * jp.traversability_mask
    ut = torch.from_numpy(u_t) * tp._mask_on_device()
    valid_j, _ = jp._aggregate(uj, s_j)
    valid_t, _ = tp._aggregate(ut, torch.from_numpy(s_t))
    assert valid_t == valid_j
    assert float(ut.sum()) == pytest.approx(float(uj.sum()), rel=RTOL)

    mask_j = jp.compute_traversability_mask(s_j, c2w)
    mask_t = tp.compute_traversability_mask(s_t, c2w)
    np.testing.assert_array_equal(mask_t, mask_j)
    uj, ut = u_j * mask_j, torch.from_numpy(u_t * mask_t)
    valid_j, _ = jp._aggregate(uj, s_j)
    valid_t, _ = tp._aggregate(ut, torch.from_numpy(s_t))
    assert valid_t == valid_j
    assert float(ut.sum()) == pytest.approx(float(uj.sum()), rel=RTOL)
    # the refilter cuts the mass to the reachable surface
    assert float(uj.sum()) < 0.1 * float(u_j.sum())
