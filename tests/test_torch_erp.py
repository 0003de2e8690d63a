"""The port's ERP geometry and projection trio (geometry/erp.py,
geometry/projection.py) against naruto_tpu's on the CPU, on numpy-seeded
inputs, with the round trips of tests/test_sim.py::TestERP and ::TestP2E.
Tolerance: rel 1e-6 of the largest value (f32 on both sides; XLA's and
torch's sin/cos/atan2 and small matmuls differ in the last ulp), but for
p2e_with_pose: there a 1-ulp difference of the rotated ray (XLA's [.., 3]
@ [3, 3] rounds otherwise than torch's) is divided by its depth and scaled
by the focal length into the sample's pixel coordinate, which moves a
bilinear sample of a random image by up to ~2e-6 of its range: rel 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.geometry import erp as jerp
from naruto_tpu.geometry import projection as jproj
from naruto_tpu_torch.geometry import erp as terp
from naruto_tpu_torch.geometry import projection as tproj
from naruto_tpu_torch.sim.analytic import AnalyticSimulator
from naruto_tpu_torch.config import make_config

torch.set_num_threads(1)

REL = 1e-6


def _close(got, want, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got.astype(np.float64) - want).max()) <= rel * scale


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("hw", [(16, 32), (64, 128), (7, 13)])
def test_erp_ray_dirs(hw):
    _close(terp.erp_ray_dirs(*hw), jerp.erp_ray_dirs(*hw))


def test_analytic_sim_reads_erp_dirs_from_geometry():
    """The analytic simulator's ERP rays are geometry/erp.py's table."""
    cfg = make_config("Replica", "office0", overrides={
        "cam": {"H": 24, "W": 32}, "sim": {"pinhole_hw": (24, 32),
                                          "erp_hw": (16, 32)}})
    sim = AnalyticSimulator(cfg, "cpu")
    assert torch.equal(sim._erp_dirs, terp.erp_ray_dirs(16, 32).reshape(-1,
                                                                        3))


def test_dirs_to_erp_uv():
    d = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for g, w in zip(terp.dirs_to_erp_uv(_t(d)), jerp.dirs_to_erp_uv(d)):
        _close(g, w)


@pytest.mark.parametrize("channels,wrap", [(0, False), (3, False),
                                           (0, True), (3, True)])
def test_bilinear_sample_2d(channels, wrap):
    rng = np.random.default_rng(1)
    shape = (12, 20, channels) if channels else (12, 20)
    img = rng.uniform(-2, 2, shape).astype(np.float32)
    v = rng.uniform(-2, 14, (9, 7)).astype(np.float32)
    u = rng.uniform(-25, 45, (9, 7)).astype(np.float32)
    _close(terp.bilinear_sample_2d(_t(img), _t(v), _t(u), wrap_u=wrap),
           jerp.bilinear_sample_2d(jnp.asarray(img), jnp.asarray(v),
                                   jnp.asarray(u), wrap_u=wrap))


@pytest.mark.parametrize("fov", [90.0, 60.0])
def test_pinhole_dirs(fov):
    _close(terp.pinhole_dirs(10, 14, fov), jerp.pinhole_dirs(10, 14, fov))


def test_depth2dist():
    depth = np.random.default_rng(2).uniform(0.5, 4, (10, 12)).astype(
        np.float32)
    _close(terp.depth2dist(_t(depth), 5.0, 6.0, 4.5, 5.5),
           jerp.depth2dist(jnp.asarray(depth), 5.0, 6.0, 4.5, 5.5))


def test_face_rotations():
    np.testing.assert_array_equal(terp.FACE_ROTATIONS, jerp.FACE_ROTATIONS)


def _erp_pattern(H=48, W=96, channels=0):
    v = np.linspace(0, 1, H, dtype=np.float32)[:, None]
    u = np.linspace(0, 1, W, dtype=np.float32)[None, :]
    img = np.sin(4 * np.pi * u) * np.cos(2 * np.pi * v) + 2.0
    if channels:
        img = np.stack([img * (k + 1) for k in range(channels)], -1)
    return img.astype(np.float32)


@pytest.mark.parametrize("face", range(6))
@pytest.mark.parametrize("channels", [0, 3])
def test_e2p(face, channels):
    img = _erp_pattern(channels=channels)
    _close(terp.e2p(_t(img), terp.FACE_ROTATIONS[face], 16),
           jerp.e2p(jnp.asarray(img), jerp.FACE_ROTATIONS[face], 16))


@pytest.mark.parametrize("channels", [0, 3])
def test_c2e(channels):
    rng = np.random.default_rng(3)
    shape = (6, 12, 12, channels) if channels else (6, 12, 12)
    faces = rng.uniform(0, 3, shape).astype(np.float32)
    _close(terp.c2e(_t(faces), 16, 32), jerp.c2e(jnp.asarray(faces), 16, 32))


@pytest.mark.parametrize("channels", [0, 3])
def test_p2e_with_pose(channels):
    rng = np.random.default_rng(4)
    shape = (20, 24, channels) if channels else (20, 24)
    persp = rng.uniform(0, 2, shape).astype(np.float32)
    from scipy.spatial.transform import Rotation

    R = Rotation.from_euler("xyz", [10, 40, -5], degrees=True).as_matrix()
    R = R.astype(np.float32)
    _close(terp.p2e_with_pose(_t(persp), R, 16, 32, 12.0, 12.0, 11.5, 9.5,
                              fill=-1.0),
           jerp.p2e_with_pose(jnp.asarray(persp), R, 16, 32, 12.0, 12.0,
                              11.5, 9.5, fill=-1.0), rel=1e-5)


def test_erp_depth_to_dist():
    d = np.random.default_rng(5).uniform(0.5, 3, (16, 32)).astype(
        np.float32)
    d[0, :4] = 0.0
    got = terp.erp_depth_to_dist(_t(d), face_hw=32)
    want = jerp.erp_depth_to_dist(jnp.asarray(d), face_hw=32)
    _close(got, want)
    assert (got.numpy()[0, :4] == 1e8).all()


def test_projection_trio():
    rng = np.random.default_rng(6)
    depth = rng.uniform(0.5, 3, (6, 8)).astype(np.float32)
    K = np.array([[5.0, 0, 3.5, 0], [0, 6.0, 2.5, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float32)
    inv_K = np.linalg.inv(K).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    pts_t = tproj.backproject(_t(depth), _t(inv_K))
    pts_j = jproj.backproject(jnp.asarray(depth), jnp.asarray(inv_K))
    _close(pts_t, pts_j)
    moved_t = tproj.transform3d(_t(T), pts_t)
    _close(moved_t, jproj.transform3d(jnp.asarray(T), pts_j))
    _close(tproj.project(moved_t, _t(K)),
           jproj.project(jproj.transform3d(jnp.asarray(T), pts_j),
                         jnp.asarray(K)))
    # the round trip: back-projected pixels project back onto the grid
    uv = tproj.project(pts_t, _t(K)).numpy()
    v, u = np.meshgrid(np.arange(6), np.arange(8), indexing="ij")
    np.testing.assert_allclose(uv, np.stack([u.ravel(), v.ravel()], -1),
                               atol=1e-5)


# ---------------------------------------- tests/test_sim.py's round trips
def test_ray_dirs_unit_and_axes():
    d = terp.erp_ray_dirs(64, 128).numpy()
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d[32, 64], [0, 0, 1], atol=0.06)
    assert d[0, :, 1].mean() < -0.95


def test_uv_roundtrip():
    v, u = terp.dirs_to_erp_uv(terp.erp_ray_dirs(32, 64))
    vv = (np.arange(32) + 0.5) / 32
    uu = (np.arange(64) + 0.5) / 64
    np.testing.assert_allclose(v.numpy(), np.tile(vv[:, None], (1, 64)),
                               atol=1e-5)
    np.testing.assert_allclose(u.numpy(), np.tile(uu[None], (32, 1)),
                               atol=1e-5)


def test_e2p_c2e_roundtrip_constant():
    erp = torch.full((64, 128), 3.0)
    faces = torch.stack([terp.e2p(erp, terp.FACE_ROTATIONS[i], 32)
                         for i in range(6)])
    np.testing.assert_allclose(terp.c2e(faces, 64, 128).numpy(), 3.0,
                               atol=1e-4)


def test_constant_depth_to_dist():
    dist = terp.erp_depth_to_dist(torch.full((32, 64), 2.0),
                                  face_hw=64).numpy()
    assert abs(dist[16, 32] - 2.0) < 0.05
    assert np.all(dist >= 2.0 - 0.05)


def test_p2e_e2p_roundtrip():
    erp = _t(_erp_pattern())
    face = terp.e2p(erp, terp.FACE_ROTATIONS[0], 64)
    back = terp.p2e_with_pose(face, terp.FACE_ROTATIONS[0], 48, 96, 32.0,
                              32.0, 31.5, 31.5, fill=-1.0).numpy()
    rows, cols = slice(20, 28), slice(44, 52)
    np.testing.assert_allclose(back[rows, cols], erp.numpy()[rows, cols],
                               atol=0.05)
    assert np.all(back[:, :8] == -1.0)
