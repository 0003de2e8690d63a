"""The hash-grid backward scan: plain versions of K1 (outer_cumsum) and K2
(chunk_totals) and the segment sum built on them, against naruto_tpu's
Pallas kernels (interpret mode) and its XLA branch. The CUDA kernels are
held against these plain versions on the card in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from naruto_tpu.ops import pallas_kernels as jpk
from naruto_tpu.ops import segment as jseg
from naruto_tpu_torch.ops import kernels, segment

torch.set_num_threads(1)


def _factors(rng, m, ka, kb):
    sa = rng.normal(size=(m, ka)).astype(np.float32)
    sb = rng.normal(size=(m, kb)).astype(np.float32)
    return (jnp.asarray(sa, jnp.bfloat16), jnp.asarray(sb, jnp.bfloat16),
            torch.tensor(sa).to(torch.bfloat16),
            torch.tensor(sb).to(torch.bfloat16))


def _bf16_products(sa_j, sb_j):
    """[M, ka*kb] f64 of the bf16-rounded products, rounded by JAX."""
    m = sa_j.shape[0]
    return np.asarray((sa_j[:, :, None] * sb_j[:, None, :])
                      .astype(jnp.float32)).reshape(m, -1).astype(np.float64)


@pytest.mark.parametrize("m,ka,kb", [(512, 8, 8), (1024, 8, 4),
                                     (4608, 2, 2)])
def test_plain_scan_matches_pallas_interpret(rng, m, ka, kb):
    """K2 + exclusive cumsum + K1 (plain) equals pallas_kernels.outer_cumsum
    in interpret mode; m=4608 crosses the Pallas 4096-row grid block.
    Tolerance 1e-6 of max|cumsum|: identical bf16 products, f32 sums in
    another order."""
    sa_j, sb_j, sa_t, sb_t = _factors(rng, m, ka, kb)
    ref = np.asarray(jpk.outer_cumsum(sa_j, sb_j, interpret=True))
    got = kernels.outer_cumsum_scan(sa_t, sb_t).numpy()
    assert got.shape == (m, ka * kb)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("m,ka,kb", [(1024, 8, 8), (4608, 8, 4)])
def test_plain_kernels_match_xla_products(rng, m, ka, kb):
    """K2 = per-chunk column sums and K1 = per-chunk prefix sums from the
    offsets, of the products as JAX's XLA branch rounds them (f64 sums of
    the same bf16 values; f32 accumulation error only)."""
    sa_j, sb_j, sa_t, sb_t = _factors(rng, m, ka, kb)
    p = _bf16_products(sa_j, sb_j).reshape(m // 512, 512, ka * kb)
    tot = kernels.chunk_totals(sa_t, sb_t).numpy()
    np.testing.assert_allclose(tot, p.sum(axis=1), rtol=0,
                               atol=1e-6 * np.abs(p).sum(axis=1).max())
    offs = rng.normal(size=(m // 512, ka * kb)).astype(np.float32)
    got = kernels.outer_cumsum(sa_t, sb_t, torch.tensor(offs)).numpy()
    ref = (offs[:, None, :] + np.cumsum(p, axis=1)).reshape(m, -1)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def test_wrapper_refuses_unpadded_m(rng):
    _, _, sa, sb = _factors(rng, 1000, 8, 8)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.chunk_totals(sa, sb)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.outer_cumsum(sa, sb, torch.zeros(1, 64))


def test_wrapper_refuses_f32_factors(rng):
    with pytest.raises(TypeError):
        kernels.chunk_totals(torch.zeros(512, 8), torch.zeros(512, 8))


def _frac_inputs(rng, n, L, per, kb):
    # level-range contract: column lv's ids in [lv*per, (lv+1)*per)
    idx = (rng.integers(0, per, (n, L))
           + np.arange(L)[None, :] * per).astype(np.int32)
    frac = rng.uniform(0, 1, (n, L, 3)).astype(np.float32)
    b = rng.normal(size=(n, L * kb)).astype(np.float32)
    return idx, frac, b, L * per


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("n,L,per,kb", [(333, 4, 16, 4), (700, 4, 300, 8)])
def test_segment_sum_frac_matches_jax(rng, use_pallas, n, L, per, kb):
    """The hash-grid backward's segment sum against JAX's Pallas branch
    (interpret) and XLA branch; n*L is never a multiple of 512, so the
    pre-sort INT32_MAX padding runs. Slot sums are differences of running
    sums, so the tolerance is relative to max|cumsum|."""
    idx, frac, b, size = _frac_inputs(rng, n, L, per, kb)
    ref = np.asarray(jseg.dense_segment_sum_outer_level_major_frac(
        jnp.asarray(idx), jnp.asarray(frac), jnp.asarray(b), size,
        use_pallas=use_pallas))
    got = segment.dense_segment_sum_outer_level_major_frac(
        torch.tensor(idx), torch.tensor(frac), torch.tensor(b), size).numpy()
    assert got.shape == (size, 8 * kb)
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


def test_pack_frac_and_weights_match_jax(rng):
    frac = rng.uniform(0, 1, (200, 3)).astype(np.float32)
    qj = jseg.pack_frac(jnp.asarray(frac))
    qt = segment.pack_frac(torch.tensor(frac))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_allclose(
        segment.corner_weights_from_packed(qt).numpy(),
        np.asarray(jseg.corner_weights_from_packed(qj)), atol=1e-7)


def test_dense_segment_sum_f32_matches_jax(rng):
    idx = rng.integers(0, 50, 900).astype(np.int32)
    vals = rng.normal(size=(900, 8)).astype(np.float32)
    ref = np.asarray(jseg.dense_segment_sum(
        jnp.asarray(idx), jnp.asarray(vals), 50, pack_bf16=False))
    got = segment.dense_segment_sum(torch.tensor(idx), torch.tensor(vals),
                                    50).numpy()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)
