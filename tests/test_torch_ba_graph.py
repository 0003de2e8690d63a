"""The BA call's static form (naruto_tpu_torch/mapping/ba_graph.py) on the
CPU, where nothing is captured: the program a CUDA graph holds, run as it
is, against the eager loop (Mapper._ba_impl_eager) bit for bit and against
the JAX package's jitted BA call; the fixed addresses a captured call
needs; the pre-drawn draws; the optimizers whose bias corrections are
device scalars, against torch.optim.Adam and the table Adam's eager
arithmetic. The card's graphs: tests/test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu.mapping.keyframes import add_keyframe as j_add_keyframe
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.mapping.ba_graph import BAGraphs
from naruto_tpu_torch.mapping.mapper import Mapper
from naruto_tpu_torch.mapping.optim import (EMBED_B1, EMBED_B2, EMBED_EPS,
                                            Adam, EmbedAdam)
from naruto_tpu_torch.utils import ckpt_io
from naruto_tpu_torch.utils.seeding import generator_states
from test_torch_mapping import (CUR_CAP, _by_group, _replay_ba_draws, _t,
                                tiny_cfg)

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
# BA calls (bucket of each) held form against form: a bucket change and
# back, the second bucket's first call included
CALLS = (512, 512, 2048, 512)
# settings of the iteration, each changing what a captured call holds
SETTINGS = {
    "hybrid": {},
    "pose": {"mapper": {"tracking_enable": True, "pose_accum_step": 2}},
    "smooth_every": {"training": {"smooth_every": 2}},
    "vertex": {"grid": {"layout": "vertex", "n_features_per_level": 2,
                        "table_dtype": "float32"}},
    "importance_pairs_weights": {
        "training": {"n_importance": 4, "smooth_sample": 16},
        "grid": {"sort_carry": "weights"}},
}


def _cfg(over=None):
    """tests/test_torch_resume.py's tiny mapper, four BA iterations: the
    uncertainty grid steps at the second and fourth."""
    over = over or {}
    return make_config("Replica", "office0", num_iter=40, overrides={
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1,
                 **over.get("grid", {})},
        "mapper": {"sample": 64, "iters": 4, "first_iters": 3,
                   "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                   "uncert_accum_iters": 2, "bound": BOUND,
                   "marching_cubes_bound": BOUND, "voxel_size": 0.5,
                   **over.get("mapper", {})},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4,
                     **over.get("training", {})}})


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


def _mapper(cfg) -> Mapper:
    """A mapper after its first frame, three keyframes and a volume
    query."""
    m = Mapper(cfg, device="cpu")
    m.update_step(0)
    m.online_recon_step(0, *_frame(0), _pose(0))
    for s in (5, 10):
        m.poses[s] = torch.from_numpy(_pose(s))
        m.add_keyframe(m.frame_to_rays(*_frame(s)), s)
    m.map_volumes()
    return m


def _static_call(graphs: BAGraphs, cur_cap, frame_rays, c2w, frame_id):
    """A BA call through the program a graph captures, run uncaptured."""
    prog, setup = graphs.load(cur_cap, frame_rays, c2w, frame_id)
    auxes = prog.run()
    graphs.mapper._ba_done(setup, frame_id)
    return auxes


def _leaves(m: Mapper) -> dict:
    """Everything a BA call changes: the full state (field, every
    optimizer's moments and count, the uncertainty gradient sum, the
    keyframes, the poses, the volume) and the generators."""
    out = {k: ckpt_io._to_numpy(x)
           for k, x in ckpt_io.flatten_with_keys(m._full_state_tree())}
    out.update({f"generator {k}": v
                for k, v in generator_states(m.gens).items()})
    return out


def _assert_same(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------ static form against eager
@pytest.mark.parametrize("name", list(SETTINGS))
def test_static_call_equals_eager_loop(name):
    """Each call of CALLS through the static form (inputs copied into the
    program's buffers, pre-drawn draws, device-scalar integers and
    optimizer scalars, one program per bucket) equals the eager loop's call
    from the same state bit for bit: every state leaf, the generators, the
    poses the pose optimisation writes back, and every loss."""
    cfg = _cfg(SETTINGS[name])
    eager, static = _mapper(cfg), _mapper(cfg)
    _assert_same(_leaves(static), _leaves(eager))
    graphs = BAGraphs(static)
    for k, bucket in enumerate(CALLS):
        fid = 15 + k
        fr = eager.frame_to_rays(*_frame(fid))
        c2w = torch.from_numpy(_pose(fid))
        want = eager._ba_impl_eager(bucket, fr, c2w, fid)
        got = _static_call(graphs, bucket, fr, c2w, fid)
        assert [list(a) for a in got] == [list(a) for a in want]
        for a, b in zip(got, want):
            for key in a:
                assert torch.equal(a[key], b[key]), (k, key)
        _assert_same(_leaves(static), _leaves(eager))
    assert sorted(graphs.programs) == [512, 2048]
    if name == "pose":
        assert not torch.equal(static.poses[5], torch.from_numpy(_pose(5)))


def test_static_call_matches_jax_ba():
    """One BA iteration through the static form against the JAX package's
    jitted call on the same weights, keyframes, volume and replayed draws
    (tests/test_torch_mapping.py's fixture, with its tolerances): the loss
    to 1e-6, and the first Adam step's parameters by share."""
    cfg = tiny_cfg(iters=1, uncert_accum_iters=1)
    rng = np.random.default_rng(0)
    color = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[:3] = 0.0
    mj = jmapper.Mapper(cfg)
    mt = Mapper(cfg, device="cpu")
    fr_j, fr_t = mj.frame_to_rays(color, depth), mt.frame_to_rays(color,
                                                                 depth)
    mt.load_weights(jax.tree_util.tree_map(np.asarray, mj.state.params))
    kf, poses = mj.state.kf, mj.state.poses
    for s in range(3):
        key = jax.random.PRNGKey(20 + s)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.1 * s, -0.05 * s, 0.0]
        kf = j_add_keyframe(kf, fr_j, s * 5, key)
        poses = poses.at[s * 5].set(c2w)
        mt.add_keyframe(fr_t, s * 5, _t(jax.random.uniform(key, (24 * 32,))))
        mt.poses[s * 5] = _t(c2w)
    uvol = rng.uniform(0, 1, mj.vol_shape).astype(np.float32)
    uvol[uvol < 0.5] = 0.0
    mj.state = mj.state._replace(kf=kf, poses=poses,
                                 uncert_vol=jnp.asarray(uvol))
    mt.uncert_vol.copy_(_t(uvol))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.1, 0.0]
    key = jax.random.PRNGKey(9)
    seen = {}
    grad_fn = mj._grad_fn

    def recording_grad_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                          with_smooth, smooth_scale=1.0):
        loss, _ = mj._loss_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                              with_smooth)
        jax.debug.callback(lambda v: seen.update(loss=float(v)), loss)
        return grad_fn(params, key, rays_o, rays_d, t_rgb, t_d, mask,
                       with_smooth, smooth_scale=smooth_scale)

    mj._grad_fn = recording_grad_fn
    state = mj._get_ba_jit(CUR_CAP)(mj.state, fr_j, jnp.asarray(c2w), 15,
                                    key)
    jax.block_until_ready(state)
    graphs = BAGraphs(mt)
    n_valid = int(((fr_t[:, 6] > 0) & (fr_t[:, 6] <= mt.lw.depth_trunc))
                  .sum())
    draws = [_replay_ba_draws(key, mj, 3, n_valid, CUR_CAP)]
    prog, setup = graphs.load(CUR_CAP, fr_t, _t(c2w), 15, draws)
    aux = prog.run()[0]
    mt._ba_done(setup, 15)
    # f32 on both sides, summed in another order
    np.testing.assert_allclose(float(aux["total"]), seen["loss"], rtol=1e-6)
    for group, lr in (("table", cfg.mapper.lr_embed),
                      ("decoder", cfg.mapper.lr_decoder),
                      ("uncert", cfg.mapper.lr_uncert)):
        ref = _by_group(state.params)[group]
        for got, want in zip(mt._groups[group], ref):
            diff = np.abs(got.detach().numpy() - np.asarray(want))
            assert diff.max() <= 2 * lr * (1 + 1e-5), group
            assert (diff > 0.01 * lr).mean() < 0.02, group
    assert int(state.map_opt_state["embed"].count) == 1
    assert (mt.embed_opt.count, mt.decoder_opt.count,
            mt.uncert_opt.count) == (1, 1, 1)


# --------------------------------------------------------- fixed addresses
def _ba_tensors(m: Mapper) -> dict:
    """Every tensor a BA call reads or writes beside its inputs, by name."""
    t = {"poses": m.poses, "uncert_vol": m.uncert_vol,
         "uncert_accum": m.uncert_accum, "kf.rays": m.kf.rays,
         "kf.frame_ids": m.kf.frame_ids, "bound_lo": m._bound_lo,
         "vol_max": m._vol_max}
    for group, params in m._groups.items():
        t.update({f"{group}[{i}]": p for i, p in enumerate(params)})
    for name, opt in (("decoder", m.decoder_opt), ("uncert", m.uncert_opt)):
        t.update({f"{name} m[{i}]": v for i, v in enumerate(opt.exp_avg)})
        t.update({f"{name} v[{i}]": v for i, v in enumerate(opt.exp_avg_sq)})
    t.update({f"table m[{i}]": v for i, v in enumerate(m.embed_opt.mu)})
    t.update({f"table v[{i}]": v for i, v in enumerate(m.embed_opt.nu)})
    pose = m._ba_poses
    t.update({"pose fixed": pose.fixed, "pose slot_mask": pose.slot_mask})
    for i, (leaf, acc) in enumerate(zip(pose.leaves, pose.accum)):
        t.update({f"pose leaf[{i}]": leaf, f"pose accum[{i}]": acc})
    for name, opt in (("rot", pose.opt_rot), ("trans", pose.opt_trans)):
        t.update({f"pose {name} m[{i}]": v
                  for i, v in enumerate(opt.exp_avg + opt.exp_avg_sq)})
    return {k: v.data_ptr() for k, v in t.items()}


@pytest.mark.parametrize("event", ["ba_call", "static_ba_call",
                                   "map_volumes", "add_keyframe",
                                   "load_full_state", "load_ckpt"])
def test_ba_tensors_keep_their_addresses(event, tmp_path):
    """A captured call reads and writes fixed addresses: none of the BA's
    tensors (field, optimizer moments, uncertainty volume and gradient sum,
    keyframes, pose table, pose variables) is rebound by a BA call of
    either form, a volume query, a keyframe insertion or either load; a
    load writes its values into them."""
    cfg = _cfg(SETTINGS["pose"])
    m = _mapper(cfg)
    before = _ba_tensors(m)
    fr = m.frame_to_rays(*_frame(15))
    c2w = torch.from_numpy(_pose(15))
    if event == "ba_call":
        m._ba_impl(512, fr, c2w, 15)
    elif event == "static_ba_call":
        _static_call(BAGraphs(m), 512, fr, c2w, 15)
    elif event == "map_volumes":
        u, _ = m.map_volumes()
        assert u is m.uncert_vol
    elif event == "add_keyframe":
        m.add_keyframe(fr, 15)
    else:
        src = _mapper(cfg)
        src._ba_impl(2048, fr, c2w, 15)
        path = str(tmp_path / "state.pkl")
        if event == "load_full_state":
            src.save_full_state(path)
            m.load_full_state(path)
            _assert_same(_leaves(m), _leaves(src))
        else:
            src.save_ckpt(path)
            m.load_ckpt(path)
            assert torch.equal(m.poses, src.poses)
    assert _ba_tensors(m) == before


@pytest.mark.parametrize("length", ["shorter", "longer"])
def test_load_ckpt_of_another_table_length(length, tmp_path):
    """load_ckpt writes into the pose table it has: a checkpoint of a run
    with a smaller general.num_iter (a shorter table) fills its head and
    sets the rest to the identity; a longer table is refused, and the
    mapper is left as it was."""
    from naruto_tpu_torch.config.schema import deep_update

    cfg = _cfg(SETTINGS["pose"])
    longer = deep_update(cfg, {"general": {"num_iter": 1500}})
    src = Mapper(cfg if length == "shorter" else longer, device="cpu")
    dst = Mapper(longer if length == "shorter" else cfg, device="cpu")
    assert len(src.poses) != len(dst.poses)
    for i in range(1, 6):
        src.poses[i] = torch.from_numpy(_pose(i))
    with torch.no_grad():
        src.params["sdf_mlp"][0].add_(0.5)
    src.step = 5
    path = str(tmp_path / "ckpt.pkl")
    src.save_ckpt(path)
    dst.poses[-1, 0, 3] = 7.0             # a stale pose past the head
    before = _ba_tensors(dst)
    if length == "longer":
        old = _leaves(dst)
        with pytest.raises(ValueError, match="do not fit"):
            dst.load_ckpt(path)
        _assert_same(_leaves(dst), old)
        assert dst.step == 0
        return
    dst.load_ckpt(path)
    n = len(src.poses)
    assert torch.equal(dst.poses[:n], src.poses)
    assert torch.equal(dst.poses[n:], torch.eye(4).expand(
        len(dst.poses) - n, 4, 4))
    assert torch.equal(dst.params["sdf_mlp"][0], src.params["sdf_mlp"][0])
    assert dst.step == 5
    assert _ba_tensors(dst) == before


# ------------------------------------------------------------- the draws
@pytest.mark.parametrize("name", ["hybrid", "importance_pairs_weights"])
def test_predrawn_draws_equal_interleaved(name):
    """A call's draws made first, then stacked into the program's buffers,
    equal the eager loop's draws, made one iteration at a time between the
    iterations, bit for bit: each site has its own generator."""
    cfg = _cfg(SETTINGS[name])
    eager, static = _mapper(cfg), _mapper(cfg)
    seen = []
    draw = eager._draw_ba

    def recording(setup):
        seen.append(draw(setup))
        return seen[-1]

    eager._draw_ba = recording
    fr = eager.frame_to_rays(*_frame(15))
    c2w = torch.from_numpy(_pose(15))
    eager._ba_impl_eager(512, fr, c2w, 15)
    prog, _ = BAGraphs(static).load(512, fr, c2w, 15)
    assert len(seen) == cfg.mapper.iters
    for field, buf in zip(prog.draws._fields, prog.draws):
        want = [getattr(d, field) for d in seen]
        if buf is None:
            assert all(w is None for w in want), field
            continue
        for it, w in enumerate(want):
            assert torch.equal(buf[it], w), (field, it)
    if name != "hybrid":
        assert prog.draws.importance_u is not None
        assert prog.draws.smooth_base is not None


# ---------------------------------------------------------- the optimizers
def _grads(rng, shapes):
    return [torch.from_numpy((rng.standard_normal(s)
                              * 10 ** rng.uniform(-6, 1)).astype(np.float32))
            for s in shapes]


def _device_scalars(values) -> torch.Tensor:
    """Host float64 scalars as the float32 tensor a call's row holds."""
    return torch.tensor(values, dtype=torch.float64).to(torch.float32)


def test_embed_adam_equals_eager_arithmetic():
    """The table's Adam with its corrections as float32 tensors equals the
    eager form's arithmetic with Python floats, bit for bit, over 25
    steps."""
    rng = np.random.default_rng(0)
    shapes = [(300, 64), (9, 9, 9, 8)]
    init = [torch.from_numpy(rng.uniform(-1e-4, 1e-4, s).astype(np.float32))
            for s in shapes]
    ref = [p.clone() for p in init]
    got = [p.clone() for p in init]
    mu = [torch.zeros_like(p) for p in ref]
    nu = [torch.zeros_like(p) for p in ref]
    opt = EmbedAdam(got, 1e-2)
    for count in range(1, 26):
        grads = _grads(rng, shapes)
        bc1 = 1.0 / (1.0 - EMBED_B1 ** count)
        bc2 = 1.0 / (1.0 - EMBED_B2 ** count)
        for p, m, v, g in zip(ref, mu, nu, grads):
            m.mul_(EMBED_B1).add_(g, alpha=1.0 - EMBED_B1)
            v.mul_(EMBED_B2).addcmul_(g, g, value=1.0 - EMBED_B2)
            p.sub_((m * bc1) / (torch.sqrt(v * bc2) + EMBED_EPS), alpha=1e-2)
        scal = _device_scalars(EmbedAdam.scalars(count))
        opt.step(got, grads, scal[0], scal[1])
        for a, b in zip(got + opt.mu + opt.nu, ref + mu + nu):
            assert torch.equal(a, b), count


@pytest.mark.parametrize("name", ["decoder", "uncert", "pose"])
def test_adam_equals_torch_adam(name):
    """The decoder's (coupled weight decay 1e-6), the uncertainty grid's and
    the pose Adam (two groups, their own learning rates) with device-scalar
    corrections equal torch.optim.Adam, bit for bit, over 25 steps: the
    parameters and both moments."""
    m = make_config("Replica", "office0").mapper
    rng = np.random.default_rng(1)
    if name == "pose":
        groups = [([(8, 3), (3,)], m.lr_rot), ([(8, 3), (3,)], m.lr_trans)]
        wd = 0.0
    else:
        groups = [([(63, 32), (32, 16)] if name == "decoder" else
                   [(5, 6, 7)], m.lr_decoder if name == "decoder"
                   else m.lr_uncert)]
        wd = 1e-6 if name == "decoder" else 0.0
    shapes = [s for g, _ in groups for s in g]
    init = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    ref = [p.clone().requires_grad_(True) for p in init]
    got = [p.clone() for p in init]
    torch_adam = torch.optim.Adam(
        [{"params": ref[i:i + len(g)], "lr": lr} for i, (g, lr) in
         zip((0, len(groups[0][0])), groups)],
        betas=(0.9, 0.99), eps=1e-8, weight_decay=wd)
    ours, i = [], 0
    for g, lr in groups:
        ours.append(Adam(got[i:i + len(g)], lr, (0.9, 0.99), 1e-8, wd))
        i += len(g)
    for count in range(1, 26):
        grads = _grads(rng, shapes)
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        torch_adam.step()
        i = 0
        for opt in ours:
            scal = _device_scalars(opt.scalars(count))
            opt.step(grads[i:i + len(opt.params)], scal[0], scal[1])
            i += len(opt.params)
        assert all(torch.equal(a, b.detach()) for a, b in zip(got, ref)), count
        for opt, lo in zip(ours, (0, len(groups[0][0]))):
            for j, p in enumerate(opt.params):
                st = torch_adam.state[ref[lo + j]]
                assert torch.equal(opt.exp_avg[j], st["exp_avg"])
                assert torch.equal(opt.exp_avg_sq[j], st["exp_avg_sq"])


@pytest.mark.parametrize("name", ["decoder", "uncert"])
def test_adam_card_form_equals_host_form_where_exact(name):
    """The plain chain's card form (its last op ``param + step_size * (m /
    denom)`` rounded once, fused_add_: what the card's kernel is held
    against) equals the CPU chain (``param + (step_size * m) / denom``)
    bit for bit wherever both are exact: with a power-of-two step size
    the product is exact in either order, so each form rounds the same sum
    once. Over 25 steps, parameters and both moments; with the real step
    sizes the two forms part."""
    m = make_config("Replica", "office0").mapper
    rng = np.random.default_rng(4)
    shapes = ([(63, 32), (32, 16), (31, 32), (32, 3)] if name == "decoder"
              else [(5, 6, 7)])
    wd = 1e-6 if name == "decoder" else 0.0
    lr = m.lr_decoder if name == "decoder" else m.lr_uncert
    init = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]

    def run(step_of):
        forms = [Adam([p.clone() for p in init], lr, (0.9, 0.99), 1e-8, wd)
                 for _ in range(2)]
        for count in range(1, 26):
            grads = _grads(np.random.default_rng(count), shapes)
            bc2_sqrt, step = _device_scalars(forms[0].scalars(count))
            for opt, card in zip(forms, (True, False)):
                opt.step_plain(grads, bc2_sqrt, step_of(step), card=card)
        card, host = forms
        return [torch.equal(a, b) for a, b in zip(
            card.params + card.exp_avg + card.exp_avg_sq,
            host.params + host.exp_avg + host.exp_avg_sq)]

    assert all(run(lambda step: torch.tensor(-2.0 ** -7)))
    assert not all(run(lambda step: step))


@pytest.mark.parametrize("fault", ["non_contiguous", "float64", "shape",
                                   "moment_shape", "scalar_dtype",
                                   "scalar_shape", "device", "count"])
def test_step_launch_refuses_bad_leaves(fault):
    """The card kernels' launcher checks every leaf before it launches:
    contiguous float32 tensors of the parameter's shape on its device, as
    many gradients as parameters, float32 scalars of one element; each
    fault raises (here on the CPU, where nothing could launch)."""
    from naruto_tpu_torch.mapping.optim import _launch_step

    params = [torch.zeros((6, 8)), torch.zeros((5,))]
    grads = [torch.ones_like(p) for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    s0, s1 = torch.ones(()), torch.ones(())
    if fault == "non_contiguous":
        grads[0] = torch.ones((8, 6)).t()
    elif fault == "float64":
        grads[1] = grads[1].double()
    elif fault == "shape":
        grads[0] = grads[0].reshape(8, 6)
    elif fault == "moment_shape":
        nu[1] = torch.zeros((1, 5))
    elif fault == "scalar_dtype":
        s1 = s1.double()
    elif fault == "scalar_shape":
        s0 = torch.ones(2)
    elif fault == "device":
        grads[0] = grads[0].to("meta")
    else:
        grads = grads[:1]

    def no_launch(*args):
        raise AssertionError("launched")

    with pytest.raises(ValueError):
        _launch_step("embed_adam", no_launch, params, grads, mu, nu, s0, s1)


def _exact_sum_f32(p: float, s: float, q: float) -> float:
    """p + s * q rounded once to float32 (ties to even), from exact
    rationals."""
    from fractions import Fraction

    exact = Fraction(p) + Fraction(s) * Fraction(q)
    near = np.float32(float(exact))
    cands = (near, np.nextafter(near, np.float32(np.inf)),
             np.nextafter(near, np.float32(-np.inf)))
    return float(min(cands, key=lambda c: (
        abs(Fraction(float(c)) - exact),
        int(np.float32(c).view(np.uint32)) & 1)))


def test_fused_add_rounds_once():
    """fused_add_ (the card's Adam update, param + step * (m / denom) with
    one rounding) against exact rationals, on random values across scales
    and on sums whose float64 rounding lands on a float32 midpoint, where
    rounding twice (float64, then float32) goes the wrong way."""
    from naruto_tpu_torch.mapping.optim import fused_add_

    rng = np.random.default_rng(3)
    n = 3000
    p = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 2, n)).astype(
        np.float32)
    q = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 2, n)).astype(
        np.float32)
    s = np.float32(-1.2345e-3)
    # p + s * q = a float32 midpoint -+ 2^-70: float64 rounds it onto the
    # midpoint, and ties-to-even then picks the wrong neighbour
    p = np.concatenate([p, np.float32([1 + 2 ** -23, -(1 + 2 ** -23),
                                       3 + 2 ** -22])])
    q = np.concatenate([q, np.float32([1 - 2 ** -23, -(1 - 2 ** -23),
                                       2 * (1 - 2 ** -23)])])
    scale = np.float32(2 ** -24 * (1 + 2 ** -23))
    scales = np.concatenate([np.full(n, s), np.full(3, scale)])
    for sc in (s, scale):
        sel = scales == sc
        got = torch.from_numpy(p[sel].copy())
        fused_add_([got], torch.tensor(sc), [torch.from_numpy(q[sel])])
        want = [_exact_sum_f32(float(a), float(sc), float(b))
                for a, b in zip(p[sel], q[sel])]
        assert got.tolist() == want
    # several tensors at once (one flat buffer): each as it is alone
    shapes = [(7, 5), (3,), (2, 3, 4)]
    ps = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
          for sh in shapes]
    qs = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
          for sh in shapes]
    alone = [x.clone() for x in ps]
    for x, q_ in zip(alone, qs):
        fused_add_([x], torch.tensor(s), [q_])
    fused_add_(ps, torch.tensor(s), qs)
    assert all(torch.equal(x, y) for x, y in zip(ps, alone))
    twice = (torch.tensor(p[-3:]).double()
             + torch.tensor(scale).double() * torch.tensor(q[-3:]).double()
             ).float()
    assert twice.tolist() != [_exact_sum_f32(float(a), float(scale),
                                             float(b))
                              for a, b in zip(p[-3:], q[-3:])]


@pytest.mark.parametrize("name", ["hybrid", "pose"])
def test_warm_up_leaves_the_state(name):
    """The first call's warm-up (every bucket's program run once,
    uncaptured, before any capture) leaves the mapper as it was: every
    state leaf, the optimizers' counts and the generators; it made each
    bucket's program, and a call after it equals the eager call."""
    from naruto_tpu_torch.mapping.mapper import CUR_BUCKETS

    cfg = _cfg(SETTINGS[name])
    eager, static = _mapper(cfg), _mapper(cfg)
    graphs = BAGraphs(static)
    fr = eager.frame_to_rays(*_frame(15))
    c2w = torch.from_numpy(_pose(15))
    before = _leaves(static)
    graphs.warm_up(fr, c2w, 15)
    assert sorted(graphs.programs) == sorted(CUR_BUCKETS)
    after = _leaves(static)
    # the warm-up writes the call's pose into the table, as the call does
    before["['poses']"][15] = _pose(15)
    _assert_same(after, before)
    want = eager._ba_impl_eager(512, fr, c2w, 15)
    got = _static_call(graphs, 512, fr, c2w, 15)
    for a, b in zip(got, want):
        for key in a:
            assert torch.equal(a[key], b[key]), key
    _assert_same(_leaves(static), _leaves(eager))
