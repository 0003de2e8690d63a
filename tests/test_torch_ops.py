"""Port ops against naruto_tpu on identical numpy-seeded inputs (CPU):
one-blob, MLP, trilinear sample and its VJP, hash encode and its VJP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.ops import encoding as jenc
from naruto_tpu.ops.grid_sample import trilinear_sample as j_trilinear
from naruto_tpu.ops.mlp import mlp_apply as j_mlp
from naruto_tpu.ops.one_blob import one_blob_encode as j_one_blob
from naruto_tpu_torch.ops import encoding as tenc
from naruto_tpu_torch.ops.grid_sample import trilinear_sample
from naruto_tpu_torch.ops.mlp import mlp_apply
from naruto_tpu_torch.ops.one_blob import one_blob_encode

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def test_one_blob_matches(rng):
    x = rng.uniform(0, 1, (257, 3)).astype(np.float32)
    # torch.special.erf and jax.lax.erf may differ in the last ulp; each
    # feature is a difference of two CDF values near 1 (ulp 1.2e-7)
    np.testing.assert_allclose(one_blob_encode(_t(x), 16).numpy(),
                               np.asarray(j_one_blob(jnp.asarray(x), 16)),
                               atol=5e-7)


def test_mlp_matches(rng):
    dims = [80, 32, 16]
    ws = [rng.uniform(-0.2, 0.2, (a, b)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(size=(300, 80)).astype(np.float32)
    # full fp32 on both sides; only the summation order differs
    np.testing.assert_allclose(
        mlp_apply([_t(w) for w in ws], _t(x)).numpy(),
        np.asarray(j_mlp([jnp.asarray(w) for w in ws], jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_trilinear_sample_and_vjp(rng, align_corners):
    vol = rng.normal(size=(5, 6, 7)).astype(np.float32)
    # includes points outside [0, 1] to exercise the border clamp
    pts = rng.uniform(-0.1, 1.1, (400, 3)).astype(np.float32)
    g = rng.normal(size=(400,)).astype(np.float32)

    def jf(v, p):
        return j_trilinear(v, p, align_corners=align_corners)

    j_out, vjp = jax.vjp(jf, jnp.asarray(vol), jnp.asarray(pts))
    j_dvol, j_dpts = vjp(jnp.asarray(g))
    tv, tp = _t(vol, True), _t(pts, True)
    out = trilinear_sample(tv, tp, align_corners=align_corners)
    d_vol, d_pts = torch.autograd.grad(out, (tv, tp), _t(g))
    # f32 on both sides; products and per-cell sums in another order
    assert _rel_err(out.detach().numpy(), j_out) < 1e-6
    assert _rel_err(d_vol.numpy(), j_dvol) < 1e-6
    assert _rel_err(d_pts.numpy(), j_dpts) < 1e-5


def _table(spec_j, scale):
    table = jenc.init_hash_table(jax.random.PRNGKey(0), spec_j)
    return jax.tree_util.tree_map(lambda a: a * scale, table)


def _flat(table):
    return ([table["hash"], *table["dense"]] if isinstance(table, dict)
            else [table])


@pytest.mark.parametrize("layout", ["hybrid", "cell"])
@pytest.mark.parametrize("gather_dtype", ["bfloat16", "float32"])
def test_hash_encode_and_vjp(rng, layout, gather_dtype):
    """Forward blend (bf16 weights, bf16 weighted rows, f32 corner sum)
    and the frac-carry segment-sum backward against the JAX custom VJP
    (its XLA branch, as the JAX package runs it on the CPU)."""
    kw = dict(n_levels=3, log2_table_size=10, base_resolution=4,
              finest_resolution=16, layout=layout, gather_dtype=gather_dtype)
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    assert spec_t.level_offsets == spec_j.level_offsets
    table = _table(spec_j, 1e3)
    x = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    g = rng.normal(size=(300, spec_j.output_dim)).astype(np.float32)

    j_out, vjp = jax.vjp(lambda t: jenc.hash_encode(t, jnp.asarray(x),
                                                    spec_j), table)
    (j_grad,) = vjp(jnp.asarray(g))
    t_table = jax.tree_util.tree_map(lambda a: _t(a, True), table)
    leaves = tenc.table_leaves(t_table)
    out = tenc.hash_encode(t_table, _t(x), spec_t)
    grads = torch.autograd.grad(out, leaves, _t(g))
    # same roundings on both sides; the 8-corner f32 sum and the
    # within-slot summation order differ
    assert _rel_err(out.detach().numpy(), j_out) < 1e-6
    for got, ref in zip(grads, _flat(j_grad)):
        assert got.shape == ref.shape
        assert _rel_err(got.numpy(), ref) < 1e-5


def test_cell_indices_hash_wraps_like_uint32(rng):
    """Hashed levels: int64 arithmetic with 32-bit wrap-around gives the
    JAX uint32 hash rows exactly, also at coordinates where x*prime
    overflows 32 bits."""
    kw = dict(n_levels=4, log2_table_size=8, base_resolution=16,
              finest_resolution=512, layout="cell")
    spec_j, spec_t = jenc.HashGridSpec(**kw), tenc.HashGridSpec(**kw)
    assert not all(spec_t.dense_mask)
    x = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    j_idx, j_w = jenc._cell_indices(jnp.asarray(x), spec_j)
    t_idx, t_w = tenc._cell_indices(_t(x), spec_t)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=1e-7)


def test_derived_cell_rows_exact(rng):
    res = 5
    grid = rng.normal(size=(res + 1, res + 1, res + 1, 4)).astype(np.float32)
    ref = jenc.derived_cell_rows(jnp.asarray(grid), res, jnp.float32)
    np.testing.assert_array_equal(
        tenc.derived_cell_rows(_t(grid), res, torch.float32).numpy(),
        np.asarray(ref))


def test_position_grad_not_ported(rng):
    """Position gradients are ported now (the name is the earlier test's):
    on a zero table the embedding is flat, so d_x is exactly 0, and on a
    random one it matches jax.vjp with respect to x (tests/
    test_torch_vertex.py holds every layout)."""
    spec = tenc.HashGridSpec(n_levels=2, log2_table_size=8, base_resolution=4,
                             finest_resolution=8, layout="cell")
    spec_j = jenc.HashGridSpec(n_levels=2, log2_table_size=8,
                               base_resolution=4, finest_resolution=8,
                               layout="cell")
    x = torch.rand(4, 3, requires_grad=True)
    table = torch.zeros(spec.total_entries, spec.row_features)
    (dx,) = torch.autograd.grad(tenc.hash_encode(table, x, spec).sum(), x)
    assert torch.equal(dx, torch.zeros_like(dx))
    table = rng.normal(size=(spec.total_entries, spec.row_features)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda xx: jenc.hash_encode(jnp.asarray(table), xx,
                                                 spec_j),
                     jnp.asarray(x.detach().numpy()))
    (j_dx,) = vjp(jnp.ones((4, spec_j.output_dim), jnp.float32))
    (dx,) = torch.autograd.grad(
        tenc.hash_encode(_t(table), x, spec).sum(), x)
    assert _rel_err(dx.numpy(), j_dx) < 1e-5
