"""First-frame mapping of the port against naruto_tpu on the CPU: the same
weights, frame and replayed draws; the uncertainty grid's Adam step (lr 1)
on gradients accumulated over every iteration runs once at the end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config
from naruto_tpu.config.schema import deep_update
from naruto_tpu.mapping import mapper as jmapper
from naruto_tpu_torch.mapping.mapper import FirstFrameDraws, Mapper

torch.set_num_threads(1)

BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
ITERS = 1


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def first_frame_pair():
    cfg = deep_update(make_config("Replica", "office0", num_iter=40), {
        "cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                "cy": 11.5, "far": 5.0},
        "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
        "mapper": {"sample": 64, "first_iters": ITERS, "bound": BOUND,
                   "marching_cubes_bound": BOUND, "voxel_size": 0.5},
        "training": {"n_samples_d": 8, "n_range_d": 5, "smooth_pts": 4},
    })
    rng = np.random.default_rng(2)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[-2:] = 0.0
    color = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.2, 0.05]

    mj = jmapper.Mapper(cfg)
    mt = Mapper(cfg, device="cpu")
    mt.load_weights(jax.tree_util.tree_map(np.asarray, mj.state.params))
    key = jax.random.PRNGKey(5)
    state = mj._ff_jit(mj.state, mj.frame_to_rays(color, depth),
                       jnp.asarray(c2w), key)
    # replay _first_frame_impl's draws: split(key, iters) -> split(k, 3);
    # idx from k1, the render's z noise from the first split of k2
    draws = []
    for k in jax.random.split(key, ITERS):
        k1, k2, _ = jax.random.split(k, 3)
        k_render, _ = jax.random.split(k2)
        draws.append(FirstFrameDraws(
            idx=_t(jax.random.randint(k1, (64,), 0, 24 * 32)).long(),
            z_noise=_t(jax.random.uniform(k_render,
                                          (64, mt.rc.n_samples)))))
    auxes = mt._first_frame_impl(mt.frame_to_rays(color, depth), _t(c2w),
                                 draws)
    return state, mt, auxes, cfg


def test_losses_finite(first_frame_pair):
    _, _, auxes, _ = first_frame_pair
    assert len(auxes) == ITERS
    assert all(np.isfinite(float(a["total"])) for a in auxes)


@pytest.mark.parametrize("group,lr_name", [
    ("table", "lr_embed"), ("decoder", "lr_decoder"),
    ("uncert", "lr_uncert")])
def test_post_adam_params_by_share(first_frame_pair, group, lr_name):
    """One Adam step moves an entry by about lr*sign(g); where a near-zero
    gradient's sign (or, at the decoders' eps 1e-8, its size against eps)
    differs between the frameworks the entry lands up to 2*lr away. So:
    every entry within 2*lr, and fewer than 2% off by more than 1% of a
    step. (Over several steps these flips feed back and the two runs drift
    apart, so the test takes one iteration.)"""
    state, mt, _, cfg = first_frame_pair
    lr = getattr(cfg.mapper, lr_name)
    p = state.params
    ref = {"table": [p["table"]["hash"], *p["table"]["dense"]],
           "decoder": [*p["sdf_mlp"], *p["color_mlp"]],
           "uncert": [p["uncert_grid"]]}[group]
    for got, want in zip(mt._groups[group], ref):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        assert diff.max() <= 2 * lr * (1 + 1e-5)
        assert (diff > 0.01 * lr).mean() < 0.02


def test_first_pose_recorded(first_frame_pair):
    _, mt, _, _ = first_frame_pair
    np.testing.assert_allclose(mt.poses[0, :3, 3].numpy(), [0.1, -0.2, 0.05])
