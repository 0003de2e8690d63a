"""The hash-grid backward scan: the plain versions of the fused scan's two
epilogues (full rows, slot rows) and the segment sum built on them, against
naruto_tpu's Pallas kernels (interpret mode) and its XLA branch; the slot
rows' scatter rule (what the CUDA kernel stores) on layouts of keys that
stress it. The CUDA kernel is held against these plain versions on the card
in test_torch_cuda.py."""
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
    """The full-row scan (plain) equals pallas_kernels.outer_cumsum in
    interpret mode; m=4608 crosses the Pallas 4096-row grid block.
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
    """The full-row scan is the prefix sum of the products as JAX's XLA
    branch rounds them (f64 sums of the same bf16 values; f32 accumulation
    error only), and its plain version is what the wrapper runs on the
    CPU."""
    sa_j, sb_j, sa_t, sb_t = _factors(rng, m, ka, kb)
    ref = np.cumsum(_bf16_products(sa_j, sb_j), axis=0)
    got = kernels.outer_cumsum_scan(sa_t, sb_t).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_array_equal(
        got, kernels.outer_cumsum_scan_plain(sa_t, sb_t).numpy())


def test_wrapper_refuses_unpadded_m(rng):
    _, _, sa, sb = _factors(rng, 1000, 8, 8)
    si = torch.zeros(1000, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.outer_cumsum_scan(sa, sb)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.outer_cumsum_slots(si, sa, sb, 10)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.outer_cumsum_scan(sa[:0], sb[:0])


def test_wrapper_refuses_f32_factors(rng):
    si = torch.zeros(512, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.outer_cumsum_scan(torch.zeros(512, 8), torch.zeros(512, 8))
    with pytest.raises(TypeError):
        kernels.outer_cumsum_slots(si, torch.zeros(512, 8),
                                   torch.zeros(512, 8), 4)
    _, _, sa, sb = _factors(rng, 512, 8, 8)
    with pytest.raises(ValueError, match="int32"):
        kernels.outer_cumsum_slots(si.long(), sa, sb, 4)
    with pytest.raises(ValueError, match="size"):
        kernels.outer_cumsum_slots(si, sa, sb, -1)


# Layouts of sorted keys that stress the slot rows' scatter rule: (name,
# real rows, size). Real rows not a multiple of 512 are padded with
# INT32_MAX keys, as the hash backward pads them.
KEY_LAYOUTS = [
    ("uniform", 1536, 700),             # no pads
    ("uniform", 1400, 700),             # 136 pads
    ("first_key_late", 1100, 900),      # hi[0 .. si[0]) is zeros
    ("last_key_early", 1536, 900),      # the last key < size - 1
    ("long_gaps", 1300, 5000),          # runs of thousands of empty slots
    ("one_key_spans_chunks", 2048, 400),  # one key over >= 3 chunks
    ("single_slot", 512, 1),
]


def _layout_keys(rng, name, n, size):
    if name == "uniform":
        keys = rng.integers(0, size, n)
    elif name == "first_key_late":
        keys = rng.integers(size // 2, size, n)
    elif name == "last_key_early":
        keys = rng.integers(0, size // 3, n)
    elif name == "long_gaps":
        keys = np.concatenate([rng.integers(0, 5, n // 3),
                               rng.integers(2500, 2510, n // 3),
                               rng.integers(size - 3, size, n - 2 * (n // 3))])
    elif name == "one_key_spans_chunks":
        keys = np.concatenate([rng.integers(0, 100, 200), np.full(1600, 150),
                               rng.integers(151, size, n - 1800)])
    else:
        keys = np.zeros(n, np.int64)
    keys = np.sort(keys).astype(np.int32)
    pad = (-n) % 512
    return np.concatenate([keys, np.full(pad, 2 ** 31 - 1, np.int32)])


def _scatter_rule(si, cs, size):
    """What the CUDA kernel stores, row by row: a row whose key a differs
    from the next key b (INT32_MAX after the last row) writes its prefix
    sum to hi[max(a, 0) .. min(b, size)); zeros go to hi[0 .. si[0]).
    Counts the writes of each slot row."""
    hi = np.full((size, cs.shape[1]), np.nan, np.float32)
    writes = np.zeros(size, np.int64)
    nxt = np.append(si[1:], 2 ** 31 - 1)
    for r in range(len(si)):
        if si[r] != nxt[r]:
            lo, end = max(int(si[r]), 0), min(int(nxt[r]), size)
            hi[lo:end] = cs[r]
            writes[lo:end] += 1
    z = min(max(int(si[0]), 0), size)
    hi[:z] = 0.0
    writes[:z] += 1
    return hi, writes


@pytest.mark.parametrize("name,n,size", KEY_LAYOUTS)
def test_slot_rows_scatter_rule_matches_plain(rng, name, n, size):
    """The slot rows the kernel's scatter rule writes equal the plain
    version's rank search + gather + select bit for bit, and every slot row
    is written exactly once (so the kernel needs no memset)."""
    si = _layout_keys(rng, name, n, size)
    _, _, sa, sb = _factors(rng, si.shape[0], 8, 8)
    cs = kernels.outer_cumsum_scan(sa, sb).numpy()
    hi, writes = _scatter_rule(si, cs, size)
    assert (writes == 1).all()
    got = kernels.outer_cumsum_slots(torch.tensor(si), sa, sb, size).numpy()
    np.testing.assert_array_equal(got, hi)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("name,n,size", KEY_LAYOUTS)
def test_slot_rows_match_jax_outer_from_sorted(rng, use_pallas, name, n,
                                               size):
    """The port's post-sort tail (slot rows, then the adjacent difference)
    against naruto_tpu.ops.segment._outer_from_sorted on the same sorted
    keys and factors, through its Pallas branch (interpret) and its XLA
    branch. Slot sums are differences of running sums, so the tolerance is
    2e-6 of max|cumsum|; the slot rows themselves are that cumsum."""
    si = _layout_keys(rng, name, n, size)
    sa_j, sb_j, sa_t, sb_t = _factors(rng, si.shape[0], 8, 4)
    ref = np.asarray(jseg._outer_from_sorted(
        jnp.asarray(si), sa_j, sb_j, 8, 4, size, use_pallas))
    got = segment._outer_from_sorted(torch.tensor(si), sa_t, sb_t,
                                     size).numpy()
    assert got.shape == ref.shape == (size, 32)
    ref_hi = np.cumsum(ref.astype(np.float64), axis=0)
    scale = np.abs(ref_hi).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)
    hi = kernels.outer_cumsum_slots(torch.tensor(si), sa_t, sb_t, size)
    np.testing.assert_allclose(hi.numpy(), ref_hi, rtol=0, atol=2e-6 * scale)


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
                                    50, pack_bf16=False).numpy()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)
