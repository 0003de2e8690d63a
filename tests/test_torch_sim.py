"""The port's analytic simulator (the slice's frame source) against
naruto_tpu's on the CPU."""
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config
from naruto_tpu.config.schema import deep_update
from naruto_tpu.sim.analytic import AnalyticSimulator as JaxSim
from naruto_tpu_torch.sim.analytic import AnalyticSimulator

torch.set_num_threads(1)


def _cfg(scene):
    cfg = make_config("Replica", "office0", num_iter=40)
    return deep_update(cfg, {
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5},
        "sim": {"pinhole_hw": (24, 32), "erp_hw": (8, 16),
                "analytic_scene": scene}})


@pytest.mark.parametrize("scene", ["box_room", "dynamic_room"])
def test_frames_match_jax(scene):
    cfg = _cfg(scene)
    sj, st = JaxSim(cfg), AnalyticSimulator(cfg, device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    c2w[:3, 3] = [0.3, -0.4, 0.2]
    for s in (sj, st):
        s.update_step(7)
    ref = [np.asarray(a) for a in sj.simulate(c2w, return_erp=True)]
    got = [a.numpy() for a in st.simulate(c2w, return_erp=True)]
    for r, g in zip(ref, got):
        assert r.shape == g.shape
    # 64 sphere-tracing steps in f32: the hit test can flip on a grazing
    # ray, so compare where both hit, and ask that almost all agree
    for depth_r, depth_g, invalid in ((ref[1], got[1], 0.0),
                                      (ref[3], got[3], 1e8)):
        both = (depth_r != invalid) & (depth_g != invalid)
        assert both.mean() > 0.95 * (depth_r != invalid).mean()
        np.testing.assert_allclose(depth_g[both], depth_r[both], rtol=1e-4)
    hit = got[1] > 0
    np.testing.assert_allclose(got[0][hit], ref[0][hit], atol=1e-3)


def test_gt_sdf_matches_jax(rng):
    cfg = _cfg("box_room")
    pts = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        AnalyticSimulator(cfg, device="cpu").gt_sdf(pts),
        JaxSim(cfg).gt_sdf(pts), atol=1e-6)
