"""The port's field, renderer, losses and mapper against naruto_tpu on the
CPU, on identical inputs: numpy-seeded data, weights carried across, and
every random draw replayed from the JAX key splits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config
from naruto_tpu.config.schema import deep_update
from naruto_tpu.mapping import field as jfield
from naruto_tpu.mapping import losses as jlosses
from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu.mapping import render as jrender
from naruto_tpu.mapping.keyframes import add_keyframe as j_add_keyframe
from naruto_tpu_torch.mapping import field as tfield
from naruto_tpu_torch.mapping import losses as tlosses
from naruto_tpu_torch.mapping import render as trender
from naruto_tpu_torch.mapping.mapper import BADraws, Mapper
from naruto_tpu_torch.ops import kernels, primitives
from naruto_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
SPEC_KW = dict(bound=BOUND, n_levels=4, log2_hashmap_size=12,
               base_resolution=8, voxel_sdf=0.1, uncert_voxel_size=0.5,
               table_layout="hybrid", table_dtype="bfloat16")


def tiny_cfg(**mapper_over):
    cfg = make_config("Replica", "office0", num_iter=40)
    return deep_update(cfg, {
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "iters": 3, "first_iters": 5,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "bound": BOUND, "marching_cubes_bound": BOUND,
                   "voxel_size": 0.5, **mapper_over},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
    })


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


@pytest.fixture(scope="module")
def field_pair():
    spec_j = jfield.FieldSpec(**SPEC_KW)
    spec_t = tfield.FieldSpec(**SPEC_KW)
    params_j = jfield.init_field_params(jax.random.PRNGKey(3), spec_j)
    # scale the table up so the hash features matter at this tiny size
    params_j["table"] = jax.tree_util.tree_map(lambda a: a * 1e3,
                                               params_j["table"])
    params_j["uncert_grid"] = params_j["uncert_grid"] + jnp.asarray(
        np.random.default_rng(1).normal(size=spec_j.uncert_shape),
        jnp.float32)
    params_t = load_jax_params(jax.tree_util.tree_map(np.asarray, params_j))
    return spec_j, spec_t, params_j, params_t


class TestFieldRenderLosses:
    def test_field_query_plus_embed(self, field_pair, rng):
        spec_j, spec_t, pj, pt = field_pair
        x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
        xe = rng.uniform(0, 1, (64, 3)).astype(np.float32)
        raw_j, emb_j = jfield.field_query_plus_embed(
            pj, jnp.asarray(x), jnp.asarray(xe), spec_j)
        raw_t, emb_t = tfield.field_query_plus_embed(pt, _t(x), _t(xe),
                                                     spec_t)
        # identical roundings (bf16 gather/blend); f32 sums in another order
        assert _rel_err(raw_t.numpy(), raw_j) < 1e-5
        assert _rel_err(emb_t.numpy(), emb_j) < 1e-6
        sdf_j, u_j = jfield.query_sdf(pj, jnp.asarray(x), spec_j, True)
        sdf_t, u_t = tfield.query_sdf(pt, _t(x), spec_t, True)
        assert _rel_err(sdf_t.numpy(), sdf_j) < 1e-5
        assert _rel_err(u_t.numpy(), u_j) < 1e-6

    def _rays(self, rng, n=48):
        rays_o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        rays_d = rng.normal(size=(n, 3)).astype(np.float32)
        rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
        target_d = rng.uniform(0.3, 1.5, (n, 1)).astype(np.float32)
        target_d[:5] = 0.0                         # invalid-depth fallback
        return rays_o, rays_d, target_d

    def test_render_rays(self, field_pair, rng):
        spec_j, spec_t, pj, pt = field_pair
        rc = jrender.RenderConfig(n_range_d=5, n_samples_d=8)
        rays_o, rays_d, target_d = self._rays(rng)
        z_noise = rng.uniform(0, 1, (48, rc.n_samples)).astype(np.float32)
        extra = rng.uniform(0, 1, (27, 3)).astype(np.float32)
        rj = jrender.render_rays(pj, spec_j, rc, None, jnp.asarray(rays_o),
                                 jnp.asarray(rays_d), jnp.asarray(target_d),
                                 extra_pts01=jnp.asarray(extra),
                                 z_noise=jnp.asarray(z_noise))
        rt = trender.render_rays(pt, spec_t, trender.RenderConfig(*rc),
                                 _t(rays_o), _t(rays_d), _t(target_d),
                                 _t(z_noise), extra_pts01=_t(extra))
        # linspace points may differ by an ulp; the field's f32 sums run in
        # another order (a few ulps of the largest value)
        assert _rel_err(rt["z_vals"].numpy(), rj["z_vals"]) < 1e-6
        for k in ("rgb", "depth", "depth_var", "acc", "sdf", "weights",
                  "uncert_map", "extra_embed"):
            assert _rel_err(rt[k].numpy(), rj[k]) < 5e-6, k

    def test_smoothness_points_replayed(self, field_pair):
        spec_j, spec_t, _, _ = field_pair
        lw = jlosses.LossWeights(smooth_pts=5)
        key = jax.random.PRNGKey(11)
        ref, n = jlosses.smoothness_points(spec_j, key, lw)
        k1, k2, _ = jax.random.split(key, 3)
        got, n_t = tlosses.smoothness_points(
            spec_t, tlosses.LossWeights(*lw),
            _t(jax.random.uniform(k1, (3,))),
            _t(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3))
        assert n_t == n
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)

    def test_total_loss(self, field_pair, rng):
        spec_j, _, pj, _ = field_pair
        n, s = 40, 13
        lw = jlosses.LossWeights(smooth_pts=4)
        rend = {
            "rgb": rng.uniform(0, 1, (n, 3)), "depth": rng.uniform(0, 2, n),
            "sdf": rng.normal(size=(n, s)),
            "z_vals": np.sort(rng.uniform(0, 3, (n, s)), axis=-1),
            "uncert_map": rng.uniform(0.01, 1, n),
            "extra_embed": rng.normal(size=(27, 32)),
        }
        rend = {k: v.astype(np.float32) for k, v in rend.items()}
        t_rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        t_d = rng.uniform(0, 2.5, (n, 1)).astype(np.float32)
        t_d[:4] = 0.0
        mask = np.ones(n, np.float32)
        mask[-6:] = 0.0                          # padded rays add nothing
        _, aux_j = jlosses.total_loss(
            pj, spec_j, {k: jnp.asarray(v) for k, v in rend.items()},
            jnp.asarray(t_rgb), jnp.asarray(t_d), jnp.asarray(mask), None, lw)
        _, aux_t = tlosses.total_loss(
            {k: _t(v) for k, v in rend.items()}, _t(t_rgb), _t(t_d),
            _t(mask), tlosses.LossWeights(*lw))
        assert set(aux_t) == set(aux_j)
        for k in aux_j:
            np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                       rtol=2e-6, err_msg=k)


# ------------------------------------------------- one BA iteration vs JAX
CUR_CAP = 512
# calls of each kernel wrapper in one BA iteration (chip_smoke.py checks the
# same launch counts on the card): wrapper -> (module, calls)
WRAPPER_CALLS_PER_BA_ITER = {"gather_rows": (primitives, 5),
                             "sorted_segment_sum": (primitives, 1),
                             "row_cumsum": (primitives, 0),
                             "outer_cumsum_slots": (kernels, 1),
                             "outer_cumsum_scan": (kernels, 0)}


def _frame(rng, H=24, W=32):
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[:3] = 0.0                                 # invalid rows
    color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    return color, depth


def _replay_ba_draws(key, mapper_j, kf_count, n_valid, cur_cap):
    """The draws of _ba_impl's first iteration, from the same key splits:
    split(key, iters) -> split(k, 3) -> randint/randint/_loss_fn splits."""
    m = mapper_j.cfg.mapper
    n_os = m.sample * m.act_ray_oversample_mul
    ks = jax.random.split(jax.random.split(key, m.iters)[0], 3)
    total = max(kf_count * mapper_j.rays_per_kf, 1)
    k_render, k_smooth = jax.random.split(ks[2])
    k1, k2, _ = jax.random.split(k_smooth, 3)
    n_rays = m.sample + cur_cap // 4
    return BADraws(
        g_idx=_t(jax.random.randint(ks[0], (n_os,), 0, total)).long(),
        cur_j=_t(jax.random.randint(ks[1], (cur_cap,), 0, n_valid)).long(),
        z_noise=_t(jax.random.uniform(k_render,
                                      (n_rays, mapper_j.rc.n_samples))),
        smooth_offset=_t(jax.random.uniform(k1, (3,))),
        smooth_jitter=_t(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3))


def _by_group(tree):
    """JAX params/grads pytree -> the port's groups."""
    return {"table": [tree["table"]["hash"], *tree["table"]["dense"]],
            "decoder": [*tree["sdf_mlp"], *tree["color_mlp"]],
            "uncert": [tree["uncert_grid"]]}


@pytest.fixture(scope="module")
def ba_pair():
    """Both mappers from the same weights, keyframes (replayed insertion
    scores), poses and uncertainty volume; one BA iteration each. The JAX
    side runs its jitted _ba_impl; a debug callback records the batch, loss
    and gradients its _grad_fn saw."""
    cfg = tiny_cfg(iters=1, uncert_accum_iters=1)
    rng = np.random.default_rng(0)
    color, depth = _frame(rng)
    mj = jmapper.Mapper(cfg)
    mt = Mapper(cfg, device="cpu")
    fr_j, fr_t = mj.frame_to_rays(color, depth), mt.frame_to_rays(color,
                                                                 depth)
    mt.load_weights(jax.tree_util.tree_map(np.asarray, mj.state.params))
    kf, poses = mj.state.kf, mj.state.poses
    for s in range(3):
        key = jax.random.PRNGKey(10 + s)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.1 * s, -0.05 * s, 0.0]
        kf = j_add_keyframe(kf, fr_j, s * 5, key)
        poses = poses.at[s * 5].set(c2w)
        mt.add_keyframe(fr_t, s * 5, _t(jax.random.uniform(key, (24 * 32,))))
        mt.poses[s * 5] = _t(c2w)
    uvol = rng.uniform(0, 1, mj.vol_shape).astype(np.float32)
    uvol[uvol < 0.5] = 0.0               # ties: the selection keeps order
    mj.state = mj.state._replace(kf=kf, poses=poses,
                                 uncert_vol=jnp.asarray(uvol))
    mt.uncert_vol = _t(uvol)

    seen = {}
    grad_fn = mj._grad_fn

    def recording_grad_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                          with_smooth, smooth_scale=1.0):
        g = grad_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                    with_smooth, smooth_scale=smooth_scale)
        loss, _ = mj._loss_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                              with_smooth)
        jax.debug.callback(
            lambda *a: seen.update(batch=[np.asarray(x) for x in a[:5]],
                                   loss=float(a[5]), grads=a[6]),
            rays_o, rays_d, t_rgb, t_d, mask, loss, g)
        return g

    mj._grad_fn = recording_grad_fn
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.1, 0.0]
    key = jax.random.PRNGKey(7)
    state = mj._get_ba_jit(CUR_CAP)(mj.state, fr_j, jnp.asarray(c2w), 15,
                                    key)
    jax.block_until_ready(state)
    mj.state = state                  # the jitted step donated the old one

    setup = mt._ba_setup(CUR_CAP, fr_t, _t(c2w), 15)
    draws = _replay_ba_draws(key, mj, 3, setup.n_valid, CUR_CAP)
    batch = mt._ba_batch(setup, draws)
    # the iteration's calls of the kernel wrappers (which take their plain
    # versions here, on CPU tensors)
    calls = dict.fromkeys(WRAPPER_CALLS_PER_BA_ITER, 0)
    wrapped = {name: getattr(mod, name)
               for name, (mod, _) in WRAPPER_CALLS_PER_BA_ITER.items()}

    def counting(name):
        def call(*args, **kwargs):
            calls[name] += 1
            return wrapped[name](*args, **kwargs)
        return call

    try:
        for name, (mod, _) in WRAPPER_CALLS_PER_BA_ITER.items():
            setattr(mod, name, counting(name))
        aux, grads = mt._ba_iteration(setup, draws, 0)
    finally:
        for name, (mod, _) in WRAPPER_CALLS_PER_BA_ITER.items():
            setattr(mod, name, wrapped[name])
    return dict(seen=seen, state=state, batch=batch, aux=aux, grads=grads,
                mt=mt, mj=mj, lr=cfg.mapper, calls=calls)


class TestBAIteration:
    def test_runs_through_the_kernel_wrappers(self, ba_pair):
        """The iteration compared below gathers and sums rows through
        primitives.gather_rows / sorted_segment_sum and the hash backward's
        fused scan (the kernels on the card): the hash forward, the hash
        backward's two payload gathers and its slot-row scan, the
        uncertainty grid's cell gather and its VJP's gather and segment
        sum; never the full-row scan nor row_cumsum."""
        assert ba_pair["calls"] == {
            name: n for name, (_, n) in WRAPPER_CALLS_PER_BA_ITER.items()}

    def test_batch_matches(self, ba_pair):
        """Keyframe sampling, current-ray picks and the active-ray
        selection (ties included) pick the same rays, bit for bit."""
        for got, ref in zip(ba_pair["batch"], ba_pair["seen"]["batch"]):
            np.testing.assert_array_equal(got.numpy(), ref)

    def test_loss_matches(self, ba_pair):
        # f32 on both sides, summed in another order
        np.testing.assert_allclose(float(ba_pair["aux"]["total"]),
                                   ba_pair["seen"]["loss"], rtol=1e-6)

    @pytest.mark.parametrize("group,tol", [
        # the jitted JAX reference on the CPU leaves the hash backward's
        # bf16 outer products unrounded (XLA drops the bf16 round trip);
        # the port rounds each as the TPU kernel does. Eager, the two
        # agree to 1e-5 (test_torch_ops); jitted, to ~1e-3 of max.
        ("table", 3e-3),
        # the MLP and uncertainty-grid gradients are plain f32
        ("decoder", 1e-5), ("uncert", 1e-5)])
    def test_grads_match(self, ba_pair, group, tol):
        ref = _by_group(ba_pair["seen"]["grads"])[group]
        for got, want in zip(ba_pair["grads"][group], ref):
            assert got.shape == want.shape
            assert _rel_err(got.numpy(), want) < tol

    @pytest.mark.parametrize("group,lr_name", [
        ("table", "lr_embed"), ("decoder", "lr_decoder"),
        ("uncert", "lr_uncert")])
    def test_post_adam_params_by_share(self, ba_pair, group, lr_name):
        """A first Adam step moves an entry by about lr*sign(g): where a
        near-zero gradient's sign (or, at the decoders' eps 1e-8, its size
        against eps) differs between the two frameworks, that entry lands
        up to 2*lr away. So: every entry within 2*lr, and fewer than 2% off
        by more than 1% of a step."""
        lr = getattr(ba_pair["lr"], lr_name)
        ref = _by_group(ba_pair["state"].params)[group]
        for got, want in zip(ba_pair["mt"]._groups[group], ref):
            diff = np.abs(got.detach().numpy() - np.asarray(want))
            assert diff.max() <= 2 * lr * (1 + 1e-5)
            assert (diff > 0.01 * lr).mean() < 0.02


def test_jax_checkpoint_carries_weights(ba_pair, tmp_path, rng):
    """Mapper.save_ckpt's npz, read with numpy alone, gives the port the
    same field: predict_sdf agrees with the JAX mapper's."""
    mj = ba_pair["mj"]
    path = str(tmp_path / "ckpt.npz")
    mj.save_ckpt(path)
    mt = Mapper(mj.cfg, device="cpu")
    mt.load_weights(path)
    pts = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    assert _rel_err(mt.predict_sdf(pts), mj.predict_sdf(pts)) < 1e-5


def test_load_weights_refuses_other_layout(ba_pair):
    cfg = deep_update(ba_pair["mj"].cfg, {"grid": {"layout": "cell"}})
    with pytest.raises(ValueError, match="shapes"):
        Mapper(cfg, device="cpu").load_weights(
            jax.tree_util.tree_map(np.asarray, ba_pair["mj"].state.params))


# --------------------------------------------- mapper end to end (the mirror)
def _render_wall_frame(cfg):
    H, W = cfg.cam.H, cfg.cam.W
    depth = np.full((H, W), 1.5, dtype=np.float32)
    u = np.linspace(0, 1, W, dtype=np.float32)
    color = np.stack([np.tile(u, (H, 1)),
                      np.full((H, W), 0.3, np.float32),
                      np.full((H, W), 0.6, np.float32)], axis=-1)
    return color, depth


class TestMapperEndToEnd:
    @pytest.fixture(scope="class")
    def run(self):
        cfg = tiny_cfg()
        mapper = Mapper(cfg, device="cpu")
        color, depth = _render_wall_frame(cfg)
        c2w = np.eye(4, dtype=np.float32)
        vols_by_step = {}
        for i in range(11):
            mapper.update_step(i)
            out = mapper.online_recon_step(i, color, depth, c2w)
            if out is not None:
                vols_by_step[i] = out
        return cfg, mapper, vols_by_step

    def test_volume_cadence(self, run):
        _, _, vols = run
        assert set(vols.keys()) == {0, 5, 10}

    def test_volume_shapes(self, run):
        _, mapper, vols = run
        u, s = vols[10]
        assert tuple(u.shape) == tuple(s.shape) == mapper.vol_shape
        assert bool((u >= 0).all())

    def test_keyframes_accrue(self, run):
        _, mapper, _ = run
        assert mapper.kf.count == 3
        assert mapper.kf.frame_ids[:3].tolist() == [0, 5, 10]

    def test_field_learns_wall(self, run):
        _, mapper, _ = run
        near_cam = mapper.predict_sdf(np.array([[0.0, 0.0, 0.3]]))
        at_wall = mapper.predict_sdf(np.array([[0.0, 0.0, 1.5]]))
        assert near_cam[0] > at_wall[0]

    def test_poses_recorded(self, run):
        _, mapper, _ = run
        np.testing.assert_allclose(mapper.poses[7].numpy(), np.eye(4),
                                   atol=1e-6)


def test_cuda_mapper_refused_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        Mapper(tiny_cfg(), device="cuda")
