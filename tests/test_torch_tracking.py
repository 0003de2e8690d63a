"""The remaining mapper settings against naruto_tpu on the CPU, on identical
inputs and replayed JAX draws: the pose representation, importance
sampling (training.n_importance), the Monte-Carlo smoothness
(training.smooth_sample), tracking (mapper.tracking_enable) and the BA's
pose optimisation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from naruto_tpu.config import make_config
from naruto_tpu.config.schema import deep_update
from naruto_tpu.mapping import field as jfield
from naruto_tpu.mapping import losses as jlosses
from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu.mapping import pose_opt as jpose
from naruto_tpu.mapping import render as jrender
from naruto_tpu.mapping.keyframes import add_keyframe as j_add_keyframe
from naruto_tpu_torch.mapping import field as tfield
from naruto_tpu_torch.mapping import losses as tlosses
from naruto_tpu_torch.mapping import pose_opt as tpose
from naruto_tpu_torch.mapping import render as trender
from naruto_tpu_torch.mapping.mapper import (BADraws, Mapper, TrackDraws,
                                             _transform_rays)
from naruto_tpu_torch.utils import seeding
from naruto_tpu_torch.utils.ckpt_io import to_torch

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


# ----------------------------------------------------------------- poses
class TestPoseOpt:
    def test_axis_angle_matches_scipy(self, rng):
        r = (rng.normal(size=(10, 3)) * 1.5).astype(np.float32)
        np.testing.assert_allclose(
            tpose.axis_angle_to_matrix(_t(r)).numpy(),
            Rotation.from_rotvec(r).as_matrix(), atol=1e-5)

    def test_matches_jax(self, rng):
        """Rodrigues, the log map (also at the identity and near pi), the
        4x4 assembly and the constant-speed model, against the JAX
        functions on the same f32 inputs."""
        r = rng.normal(size=(12, 3)).astype(np.float32)
        r[0] = 0.0
        r[1] = [np.pi - 1e-3, 0.0, 0.0]
        R = np.asarray(jpose.axis_angle_to_matrix(jnp.asarray(r)))
        np.testing.assert_allclose(tpose.axis_angle_to_matrix(_t(r)).numpy(),
                                   R, atol=1e-6)
        np.testing.assert_allclose(
            tpose.matrix_to_axis_angle(_t(R)).numpy(),
            np.asarray(jpose.matrix_to_axis_angle(jnp.asarray(R))),
            atol=1e-5)
        t = rng.normal(size=(12, 3)).astype(np.float32)
        T = np.asarray(jpose.matrix_from_tensor(jnp.asarray(r),
                                                jnp.asarray(t)))
        np.testing.assert_array_equal(
            tpose.matrix_from_tensor(_t(r), _t(t)).numpy()[:, 3], T[:, 3])
        np.testing.assert_allclose(
            tpose.matrix_from_tensor(_t(r), _t(t)).numpy(), T, atol=1e-6)
        for got, ref in zip(tpose.pose_to_tensor(_t(T)),
                            jpose.pose_to_tensor(jnp.asarray(T))):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-5)
        np.testing.assert_allclose(
            tpose.const_speed_init(_t(T[2]), _t(T[3])).numpy(),
            np.asarray(jpose.const_speed_init(jnp.asarray(T[2]),
                                              jnp.asarray(T[3]))),
            atol=1e-5)

    @pytest.mark.parametrize("at", ["identity", "rotation"])
    def test_gradcheck(self, at):
        """Finite, correct gradients of Rodrigues at the identity (the Taylor
        branch) and away from it, in f64."""
        rot = torch.zeros(3, dtype=torch.float64) if at == "identity" else \
            torch.tensor([0.3, -0.2, 0.5], dtype=torch.float64)
        rot.requires_grad_(True)
        assert torch.autograd.gradcheck(
            lambda r: tpose.axis_angle_to_matrix(r) ** 2, (rot,), eps=1e-6,
            atol=1e-5)
        g = torch.autograd.grad(tpose.axis_angle_to_matrix(
            rot).square().sum(), rot)[0]
        assert torch.isfinite(g).all()

    def test_tracking_config_defaults_match_jax(self):
        assert tuple(tpose.TrackingConfig()) == tuple(jpose.TrackingConfig())


# ------------------------------------------------------ importance sampling
SPEC_KW = dict(bound=BOUND, n_levels=4, log2_hashmap_size=12,
               base_resolution=8, voxel_sdf=0.1, uncert_voxel_size=0.5,
               table_layout="hybrid", table_dtype="bfloat16")


@pytest.fixture(scope="module")
def field_pair():
    spec_j = jfield.FieldSpec(**SPEC_KW)
    spec_t = tfield.FieldSpec(**SPEC_KW)
    params_j = jfield.init_field_params(jax.random.PRNGKey(3), spec_j)
    params_j["table"] = jax.tree_util.tree_map(lambda a: a * 1e3,
                                               params_j["table"])
    params_j["uncert_grid"] = params_j["uncert_grid"] + jnp.asarray(
        np.random.default_rng(1).normal(size=spec_j.uncert_shape),
        jnp.float32)
    params_t = to_torch(jax.tree_util.tree_map(np.asarray, params_j))
    return spec_j, spec_t, params_j, params_t


class TestImportanceSampling:
    def test_sample_pdf_golden(self):
        """bins [1, 2, 3], weights [1, 3]: pdf [.25, .75], cdf [0, .25, 1];
        evenly spaced u = [0, .25, .5, .75, 1] -> [1, 2, 2+1/3, 2+2/3, 3]."""
        s = trender.sample_pdf(torch.tensor([[1.0, 2.0, 3.0]]),
                               torch.tensor([[1.0, 3.0]]), 5, det=True)
        np.testing.assert_allclose(s[0].numpy(),
                                   [1.0, 2.0, 2 + 1 / 3, 2 + 2 / 3, 3.0],
                                   atol=2e-4)

    @pytest.mark.parametrize("det", [True, False])
    def test_sample_pdf_matches_jax(self, rng, det):
        """Random bins and weights (some zero), JAX's own u replayed; the
        evenly spaced u are jnp.linspace's values. XLA's cumsum sums the
        PDF in another order, and t divides by CDF differences, which
        carries a last-bit difference of the CDF into a few ulps of the
        sample: rel 5e-6."""
        bins = np.sort(rng.uniform(0, 4, (64, 12)), axis=-1).astype(
            np.float32)
        w = rng.uniform(0, 1, (64, 11)).astype(np.float32)
        w[:8] = 0.0
        key = jax.random.PRNGKey(5)
        ref = jrender.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 9,
                                 det=det)
        u = None if det else _t(jax.random.uniform(key, (64, 9)))
        got = trender.sample_pdf(_t(bins), _t(w), 9, u, det=det)
        assert _rel_err(got.numpy(), ref) < 5e-6

    def test_sample_pdf_needs_u_when_random(self):
        with pytest.raises(ValueError, match="u"):
            trender.sample_pdf(torch.zeros(2, 4), torch.ones(2, 3), 5)

    @pytest.mark.parametrize("perturb", [1.0, 0.0])
    def test_render_rays_importance_matches_jax(self, field_pair, rng,
                                                perturb):
        """TestImportanceSampling's render: the coarse pass (with the
        smoothness points riding it), the importance draw, the merged
        re-render; every map, the coarse "0" maps and z_std, against JAX
        with its draws replayed."""
        spec_j, spec_t, pj, pt = field_pair
        rc = jrender.RenderConfig(n_range_d=5, n_samples_d=8, n_importance=4,
                                  perturb=perturb)
        n = 48
        rays_o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        rays_d = rng.normal(size=(n, 3)).astype(np.float32)
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        target_d = rng.uniform(0.3, 1.5, (n, 1)).astype(np.float32)
        target_d[:5] = 0.0
        z_noise = rng.uniform(0, 1, (n, rc.n_samples)).astype(np.float32)
        extra = rng.uniform(0, 1, (27, 3)).astype(np.float32)
        key = jax.random.PRNGKey(9)
        rj = jrender.render_rays(pj, spec_j, rc, key, jnp.asarray(rays_o),
                                 jnp.asarray(rays_d), jnp.asarray(target_d),
                                 extra_pts01=jnp.asarray(extra),
                                 z_noise=jnp.asarray(z_noise))
        imp = _t(jax.random.uniform(jax.random.fold_in(key, 1),
                                    (n, rc.n_importance)))
        rt = trender.render_rays(pt, spec_t, trender.RenderConfig(*rc),
                                 _t(rays_o), _t(rays_d), _t(target_d),
                                 _t(z_noise), extra_pts01=_t(extra),
                                 importance_u=imp if perturb else None)
        assert set(rt) == set(rj)
        assert rt["z_vals"].shape == (n, rc.n_samples + rc.n_importance)
        z = rt["z_vals"].numpy()
        assert (np.diff(z, axis=-1) >= 0).all()
        # the field's f32 sums run in another order (a few ulps). With
        # perturb == 0 the evenly spaced u include 1.0, where the last CDF
        # value (1 +- an ulp) and a bin's PDF at the 1e-5 floor decide
        # between two bins on the last bit, in either package: there only
        # the first pass is compared
        keys = sorted(rj) if perturb else [k for k in rj if k.endswith("0")
                                           or k == "extra_embed"]
        for k in keys:
            assert _rel_err(rt[k].detach().numpy(), rj[k]) < 1e-5, k


# -------------------------------------------------- Monte-Carlo smoothness
def _mc_spec():
    kw = dict(bound=((-1, 1), (-1, 1), (-1, 1)), n_levels=2,
              log2_hashmap_size=10, base_resolution=4, voxel_sdf=0.1,
              uncert_grid=False)
    return jfield.FieldSpec(**kw), tfield.FieldSpec(**kw)


def _replay_smooth(key, lw):
    """smoothness_points' draws from its key: offset, jitter, pairs."""
    k1, k2, k3 = jax.random.split(key, 3)
    n, s = lw.smooth_pts - 1, lw.smooth_sample
    out = [_t(jax.random.uniform(k1, (3,))),
           _t(jax.random.uniform(k2, (1, 3) if s else (1, 1, 1, 3))
              ).reshape(3)]
    if s:
        k3a, k3b = jax.random.split(k3)
        out += [_t(jax.random.randint(k3a, (3, s, 3), 0, n)),
                _t(jax.random.randint(k3b, (3, s, 1), 0, n - 1))]
    return out


def _embed(x01, lib):
    # tests/test_losses_golden.py's smooth analytic "embedding"
    return lib.cat([x01, x01 ** 2], -1) if lib is torch else \
        jnp.concatenate([x01, x01 ** 2], axis=-1)


class TestMonteCarloSmoothness:
    @pytest.mark.parametrize("sample", [0, 64])
    def test_points_and_tv_match_jax(self, sample):
        """The full lattice and the per-axis pairs, with the JAX key's draws
        replayed: the same points (1e-6) and the same TV (rel 1e-5)."""
        spec_j, spec_t = _mc_spec()
        lw = jlosses.LossWeights(smooth_pts=8, smooth_vox=0.2,
                                 smooth_sample=sample)
        key = jax.random.PRNGKey(4)
        x_j, n = jlosses.smoothness_points(spec_j, key, lw)
        x_t, n_t = tlosses.smoothness_points(
            spec_t, tlosses.LossWeights(*lw), *_replay_smooth(key, lw))
        assert n_t == n
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6)
        tv_j = float(jlosses.smoothness_tv(_embed(x_j, jnp), n, lw))
        tv_t = float(tlosses.smoothness_tv(_embed(x_t, torch), n,
                                           tlosses.LossWeights(*lw)))
        assert tv_t == pytest.approx(tv_j, rel=1e-5)

    def test_linear_embedding_golden(self):
        """On a linear embedding every pair along axis a differs by
        vox/extent_a, so the estimate is exact: 3 (n-1) n^2 (0.2/2)^2 /
        smooth_pts^3, for any draw."""
        _, spec_t = _mc_spec()
        lw = tlosses.LossWeights(smooth_pts=8, smooth_vox=0.2,
                                 smooth_sample=100)
        g = torch.Generator().manual_seed(0)
        x, n = tlosses.smoothness_points(
            spec_t, lw, torch.rand(3, generator=g), torch.rand(3, generator=g),
            torch.randint(0, 7, (3, 100, 3), generator=g),
            torch.randint(0, 6, (3, 100, 1), generator=g))
        want = 3 * (n - 1) * n * n * 0.1 ** 2 / 8 ** 3
        assert float(tlosses.smoothness_tv(x, n, lw)) == pytest.approx(
            want, rel=1e-5)

    def test_estimates_full_tv(self):
        """test_losses_golden.py's check, with the port's own draws: the MC
        estimate averages to the full-grid TV's magnitude."""
        _, spec_t = _mc_spec()
        lw_full = tlosses.LossWeights(smooth_pts=8, smooth_vox=0.2)
        lw_mc = lw_full._replace(smooth_sample=4096)
        g = torch.Generator().manual_seed(0)
        offset, jitter = torch.rand(3, generator=g), torch.rand(3, generator=g)
        x, n = tlosses.smoothness_points(spec_t, lw_full, offset, jitter)
        tv_full = float(tlosses.smoothness_tv(_embed(x, torch), n, lw_full))
        tvs = []
        for _ in range(8):
            x, n = tlosses.smoothness_points(
                spec_t, lw_mc, offset, jitter,
                torch.randint(0, n, (3, 4096, 3), generator=g),
                torch.randint(0, n - 1, (3, 4096, 1), generator=g))
            tvs.append(float(tlosses.smoothness_tv(_embed(x, torch), n,
                                                   lw_mc)))
        assert 0.3 < np.mean(tvs) / tv_full < 3.0

    def test_pairs_are_required(self):
        _, spec_t = _mc_spec()
        with pytest.raises(ValueError, match="smooth_sample"):
            tlosses.smoothness_points(
                spec_t, tlosses.LossWeights(smooth_sample=8), torch.zeros(3),
                torch.zeros(3))


def test_new_draw_sites_are_appended():
    """The sites of PRs before keep their indices (and so their draws)."""
    assert seeding.SITES[:8] == (
        "init", "first_frame_rays", "global_rays", "current_rays", "z_noise",
        "smoothness", "keyframe_scores", "planner_subset")
    assert seeding.SITES[8:] == ("track_rays", "importance_u",
                                 "smooth_pairs")


# ------------------------------------------------ the mapper against JAX
# "plain": tracking alone; "all": with importance samples, the MC
# smoothness and the weights carry too
SETTINGS = {
    "plain": {},
    "all": {"grid": {"sort_carry": "weights"},
            "training": {"n_importance": 4, "smooth_sample": 32}},
}
# the field's learning rates at 0: the BA's pose path compared on a field
# that both packages hold equal
FROZEN = dict(lr_embed=0.0, lr_decoder=0.0, lr_uncert=0.0)
CUR_CAP = 512


def tiny_cfg(settings, **mapper_over):
    cfg = make_config("Replica", "office0", num_iter=40)
    cfg = deep_update(cfg, {
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": 4, "first_iters": 5,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "bound": BOUND, "marching_cubes_bound": BOUND,
                   "voxel_size": 0.5, "tracking_enable": True,
                   "track_sample": 96, "track_iter": 4,
                   "track_ignore_edge_w": 3, "track_ignore_edge_h": 2,
                   "pose_accum_step": 2, **mapper_over},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
    })
    return deep_update(cfg, SETTINGS[settings])


def _frame(rng, H=24, W=32):
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[:3] = 0.0
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return color, depth


def _importance(mj, k_render, n):
    n_imp = mj.rc.n_importance
    return (_t(jax.random.uniform(jax.random.fold_in(k_render, 1),
                                  (n, n_imp))) if n_imp else None)


def _replay_track_draws(key, mj):
    """_tracking_impl's draws: split(key, iters) -> split(k, 3) -> us, the
    loss's render key, vs."""
    m = mj.cfg.mapper
    n = m.track_sample
    iw, ih = m.track_ignore_edge_w, m.track_ignore_edge_h
    draws = []
    for k in jax.random.split(key, m.track_iter):
        k1, k2, k3 = jax.random.split(k, 3)
        k_render, _ = jax.random.split(k2)
        draws.append(TrackDraws(
            us=_t(jax.random.randint(k1, (n,), iw, mj.W - iw)).long(),
            vs=_t(jax.random.randint(k3, (n,), ih, mj.H - ih)).long(),
            z_noise=_t(jax.random.uniform(k_render, (n, mj.rc.n_samples))),
            importance_u=_importance(mj, k_render, n)))
    return draws


def _replay_ba_draws(key, mj, kf_count, n_valid):
    """_ba_impl's draws with pose optimisation (the smoothness term on
    every iteration), for every iteration."""
    m = mj.cfg.mapper
    n_os = m.sample * m.act_ray_oversample_mul
    n_rays = m.sample + CUR_CAP // 4
    total = max(kf_count * mj.rays_per_kf, 1)
    lw = mj.lw
    draws = []
    for k in jax.random.split(key, m.iters):
        ks = jax.random.split(k, 3)
        k_render, k_smooth = jax.random.split(ks[2])
        smooth = _replay_smooth(k_smooth, lw)
        draws.append(BADraws(
            g_idx=_t(jax.random.randint(ks[0], (n_os,), 0, total)).long(),
            cur_j=_t(jax.random.randint(ks[1], (CUR_CAP,), 0,
                                        n_valid)).long(),
            z_noise=_t(jax.random.uniform(k_render,
                                          (n_rays, mj.rc.n_samples))),
            smooth_offset=smooth[0], smooth_jitter=smooth[1],
            importance_u=_importance(mj, k_render, n_rays),
            smooth_base=smooth[2] if len(smooth) > 2 else None,
            smooth_diffc=smooth[3] if len(smooth) > 2 else None))
    return draws


def _mapper_pair(settings, **mapper_over):
    """Both mappers from the same weights (the table scaled up so the hash
    features matter), keyframes, poses and uncertainty volume."""
    cfg = tiny_cfg(settings, **mapper_over)
    rng = np.random.default_rng(0)
    color, depth = _frame(rng)
    mj = jmapper.Mapper(cfg)
    mt = Mapper(cfg, device="cpu")
    params = jax.tree_util.tree_map(np.asarray, mj.state.params)
    params["table"] = jax.tree_util.tree_map(lambda a: a * 1e3,
                                             params["table"])
    mt.load_weights(params)
    fr_j, fr_t = mj.frame_to_rays(color, depth), mt.frame_to_rays(color,
                                                                 depth)
    kf, poses = mj.state.kf, mj.state.poses
    for s in range(3):
        key = jax.random.PRNGKey(10 + s)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.1 * s, -0.05 * s, 0.0]
        c2w[:3, :3] = Rotation.from_rotvec([0.0, 0.05 * s, 0.02 * s]) \
            .as_matrix()
        kf = j_add_keyframe(kf, fr_j, s * 5, key)
        poses = poses.at[s * 5].set(c2w)
        mt.add_keyframe(fr_t, s * 5, _t(jax.random.uniform(key, (24 * 32,))))
        mt.poses[s * 5] = _t(c2w)
    uvol = rng.uniform(0, 1, mj.vol_shape).astype(np.float32)
    uvol[uvol < 0.5] = 0.0
    mj.state = mj.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, params), kf=kf,
        poses=poses, uncert_vol=jnp.asarray(uvol))
    mt.uncert_vol = _t(uvol)
    return mj, mt, fr_j, fr_t


@pytest.mark.parametrize("settings", sorted(SETTINGS))
def test_tracking_matches_jax(settings):
    """One tracking call from a pose 3 cm and ~1 degree off, on identical
    weights and replayed draws, against the JAX package's _track_jit:
    the estimated pose within rel 1e-4, and moved off its start."""
    mj, mt, fr_j, fr_t = _mapper_pair(settings)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3] = Rotation.from_rotvec([0.01, -0.02, 0.0]).as_matrix()
    init[:3, 3] = [0.03, 0.0, -0.01]
    key = jax.random.PRNGKey(21)
    ref = np.asarray(mj._track_jit(mj.state, fr_j, jnp.asarray(init), key))
    got = mt._tracking_impl(fr_t, _t(init), _replay_track_draws(key, mj))
    assert np.abs(ref - init).max() > 1e-4
    assert _rel_err(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("field,tol", [
    # the field frozen (learning rates 0): the pose gradients agree to the
    # last bits, and so do 2 Adam steps on them
    ("frozen", 1e-6),
    # the field trained too: a first Adam step moves every table entry by
    # +-lr on the sign of its gradient, and a near-zero gradient's sign
    # differs between two f32 sum orders (test_torch_mapping.py::
    # test_post_adam_params_by_share), so from the second iteration on the
    # two fields, and the pose gradients, differ by ~1%; a pose moves
    # ~2e-3 in the step
    ("trained", 1e-3)])
@pytest.mark.parametrize("settings", sorted(SETTINGS))
def test_ba_pose_optimisation_matches_jax(settings, field, tol):
    """A BA step with pose optimisation (4 iterations, the pose Adam
    stepping every 2 on the accumulated gradients), on identical state and
    replayed draws, against the JAX package's jitted _ba_impl: the written
    back keyframe and current poses within `tol`; slot 0 unchanged."""
    mj, mt, fr_j, fr_t = _mapper_pair(settings,
                                      **(FROZEN if field == "frozen" else {}))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.1, 0.0]
    key = jax.random.PRNGKey(7)
    state = mj._get_ba_jit(CUR_CAP)(mj.state, fr_j, jnp.asarray(c2w), 15,
                                    key)
    ref = np.asarray(state.poses)
    setup = mt._ba_setup(CUR_CAP, fr_t, _t(c2w), 15)
    draws = _replay_ba_draws(key, mj, 3, setup.n_valid)
    before = mt.poses.clone()
    auxes = mt._ba_impl(CUR_CAP, fr_t, _t(c2w), 15, draws)
    got = mt.poses.numpy()
    assert len(auxes) == 4 and all(torch.isfinite(a["total"]) for a in auxes)
    np.testing.assert_array_equal(got[0], before[0].numpy())
    for fid in (5, 10, 15):
        assert np.abs(got[fid] - before[fid].numpy()).max() > 1e-4, fid
        assert _rel_err(got[fid], ref[fid]) < tol, fid


@pytest.mark.parametrize("settings", sorted(SETTINGS))
def test_loss_and_grads_match_jax(settings):
    """The mapper's loss with every setting of `settings` (importance
    draws, MC pairs) and its gradients in the field and the ray origins,
    against the JAX _loss_fn (jitted): loss rel 1e-5, gradients rel 1e-5;
    the table's 3e-3 of max|ref|, as test_torch_mapping.py's BA test (XLA
    drops the hash backward's bf16 round trips under jit; eager, the
    backward agrees to 1e-5: test_torch_vertex.py)."""
    mj, mt, fr_j, fr_t = _mapper_pair(settings)
    rng = np.random.default_rng(3)
    n = 80
    rays = fr_t[rng.integers(0, fr_t.shape[0], n)]
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.02, -0.01, 0.03])
    rays_o, rays_d, rgb, dep = _transform_rays(rays, pose.expand(n, 4, 4))
    mask = torch.ones(n)
    key = jax.random.PRNGKey(33)
    k_render, k_smooth = jax.random.split(key)
    z_noise = _t(jax.random.uniform(k_render, (n, mj.rc.n_samples)))

    def jloss(params, o):
        return mj._loss_fn(params, key, o, jnp.asarray(rays_d.numpy()),
                           jnp.asarray(rgb.numpy()), jnp.asarray(dep.numpy()),
                           jnp.asarray(mask.numpy()), True)

    (loss_j, _), (g_j, go_j) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(mj.state.params,
                                              jnp.asarray(rays_o.numpy()))
    o = rays_o.clone().requires_grad_(True)
    loss_t, _ = mt._loss_fn(o, rays_d, rgb, dep, mask, z_noise,
                            tuple(_replay_smooth(k_smooth, mj.lw)) +
                            ((None, None) if not mj.lw.smooth_sample
                             else ()),
                            importance_u=_importance(mj, k_render, n))
    grads = torch.autograd.grad(loss_t, [o] + mt._all_params())
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    assert _rel_err(grads[0].numpy(), go_j) < 1e-5
    ref = [g_j["table"]["hash"], *g_j["table"]["dense"], *g_j["sdf_mlp"],
           *g_j["color_mlp"], g_j["uncert_grid"]]
    assert len(ref) == len(grads) - 1
    n_table = len(mt._groups["table"])
    for i, (got, want) in enumerate(zip(grads[1:], ref)):
        tol = 3e-3 if i < n_table else 1e-5
        assert _rel_err(got.numpy(), want) < tol, i


def test_online_tracking_feeds_the_pose_table():
    """online_recon_step with tracking: every frame is consumed, frame i's
    pose is the tracked one from the constant-speed start, finite."""
    cfg = tiny_cfg("all", iters=2, track_iter=3)
    mapper = Mapper(cfg, device="cpu")
    color, depth = _frame(np.random.default_rng(2))
    assert all(mapper.needs_frame(i) for i in range(7))
    seen = []
    track = mapper._tracking_impl

    def recording(frame_rays, init, draws):
        out = track(frame_rays, init, draws)
        seen.append((init.clone(), out.clone()))
        return out

    mapper._tracking_impl = recording
    for i in range(7):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = 0.01 * i
        mapper.update_step(i)
        mapper.online_recon_step(i, color, depth, c2w)
    assert len(seen) == 6
    assert torch.isfinite(mapper.poses[:7]).all()
    np.testing.assert_array_equal(seen[-1][1].numpy(),
                                  mapper.poses[6].numpy())
    # step 2 starts from the constant-speed model of steps 0 and 1
    np.testing.assert_allclose(
        seen[1][0].numpy(),
        tpose.const_speed_init(mapper.poses[1], mapper.poses[0]).numpy(),
        atol=1e-6)
