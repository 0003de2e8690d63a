"""The hash-grid microbenchmark path of the port on the CPU: the plain
versions of gather_rows, sorted_segment_sum and row_cumsum against the JAX
functions the reference scripts check their Pallas kernels with (jnp.take,
jax.ops.segment_sum, jnp.cumsum), two of those Pallas bodies themselves in
interpret mode, the port's dense_segment_sum against JAX's, the index
remix, and one small call of each ported benchmark row. The CUDA kernels
are held against these plain versions on the card in test_torch_cuda.py.

The plain versions run at M = 5,000, a multiple of no TPU block size; the
Pallas bodies run at multiples of their blocks, where they are right."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from naruto_tpu.ops import segment as jseg
from naruto_tpu_torch.ops import kernels, primitives, segment
from naruto_tpu_torch.scripts import microbench_primitives as mb
from naruto_tpu_torch.scripts import microbench_round2 as mb2

torch.set_num_threads(1)

PRIME = 2654435761


def _sorted_keys(rng, m, size):
    """Sorted int32 keys in [0, size) with the last slot used and (at
    m / size < 3) empty slots."""
    keys = rng.integers(0, size, m).astype(np.int32)
    keys[-1] = size - 1
    return np.sort(keys)


def _rel_err(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


# --------------------------------------------------- dense_segment_sum fault
@pytest.mark.parametrize("kwargs", [{}, {"pack_bf16": False}],
                         ids=["default", "pack_bf16_false"])
def test_dense_segment_sum_matches_jax(rng, kwargs):
    """The port's dense_segment_sum has JAX's signature and default: with
    pack_bf16 (the default) each value is rounded to bf16 before the f32
    prefix sum. Same values either way; the f32 sums run in another order
    (JAX's sort is not stable), so 1e-6 of max|cumsum|."""
    idx = rng.integers(0, 50, 4000).astype(np.int32)
    vals = rng.normal(size=(4000, 8)).astype(np.float32)
    ref = np.asarray(jseg.dense_segment_sum(jnp.asarray(idx),
                                            jnp.asarray(vals), 50, **kwargs))
    got = segment.dense_segment_sum(torch.tensor(idx), torch.tensor(vals),
                                    50, **kwargs).numpy()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)


# ------------------------------------------------------ plain versions vs JAX
@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 8),
                                         (torch.float32, 8),
                                         (torch.bfloat16, 1)])
def test_gather_plain_matches_jnp_take(rng, dtype, width):
    """gather_rows on a CPU tensor (its plain version) is jnp.take, bit for
    bit; width 1 is the 1-D column take of the round-2 script."""
    tbl = rng.normal(size=(700, width)).astype(np.float32)
    ix = rng.integers(0, 700, 5000).astype(np.int32)
    t_tbl = torch.tensor(tbl).to(dtype)
    got = primitives.gather_rows(t_tbl, torch.tensor(ix)).float().numpy()
    j_tbl = jnp.asarray(tbl, jnp.bfloat16 if dtype == torch.bfloat16
                        else jnp.float32)
    if width == 1:
        ref = jnp.take(j_tbl[:, 0], jnp.asarray(ix), axis=0)[:, None]
    else:
        ref = jnp.take(j_tbl, jnp.asarray(ix), axis=0)
    np.testing.assert_array_equal(got, np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype,width", [(np.int32, 1), (np.int32, 3),
                                         (np.float32, 64)])
def test_gather_widened_contract_matches_jnp_take(rng, idx_dtype, dtype,
                                                  width):
    """The BA path's gathers: int32 tables (the sort payload column) and
    the int64 indices torch.sort and the index arithmetic give, bit for bit
    against jnp.take on the same numpy inputs."""
    if dtype == np.int32:
        tbl = rng.integers(-2 ** 31, 2 ** 31, (700, width)).astype(dtype)
    else:
        tbl = rng.normal(size=(700, width)).astype(dtype)
    ix = rng.integers(0, 700, 5000).astype(idx_dtype)
    got = primitives.gather_rows(torch.tensor(tbl), torch.tensor(ix))
    assert got.dtype == torch.tensor(tbl).dtype
    ref = jnp.take(jnp.asarray(tbl), jnp.asarray(ix.astype(np.int32)),
                   axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("round_bf16", [True, False])
def test_segment_sum_plain_matches_jax(rng, round_bf16):
    """sorted_segment_sum's plain version against jax.ops.segment_sum of the
    bf16-rounded (P1) or exact f32 (P7) values: empty slots are 0 and the key
    size-1 lands. The same terms summed in another order: 1e-6 of max|ref|."""
    m, size = 5000, 3000
    keys = _sorted_keys(rng, m, size)
    assert len(np.unique(keys)) < size and keys[-1] == size - 1
    vals = rng.normal(size=(m, 8)).astype(np.float32)
    jv = jnp.asarray(vals)
    if round_bf16:
        jv = jv.astype(jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(jax.ops.segment_sum(jv, jnp.asarray(keys),
                                         num_segments=size))
    got = primitives.sorted_segment_sum(torch.tensor(keys),
                                        torch.tensor(vals), size,
                                        round_bf16=round_bf16).numpy()
    assert got.shape == (size, 8)
    assert not got[np.setdiff1d(np.arange(size), keys)].any()
    assert _rel_err(got, ref) < 1e-6


def test_row_cumsum_plain_matches_jnp_cumsum(rng):
    """row_cumsum's plain version against jnp.cumsum over rows; the sums
    run in another order, so 1e-5 of max|ref| (the kernel's tolerance)."""
    x = rng.normal(size=(5000, 8)).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=0))
    got = primitives.row_cumsum(torch.tensor(x)).numpy()
    assert _rel_err(got, ref) < primitives.CUMSUM_TOL


# ---------------------------------------------- the Pallas bodies, pinned
def test_p1_body_interpret_matches_bf16_segment_sum(rng):
    """P1 (scripts/microbench_primitives.py:150-180), body copied verbatim,
    in interpret mode at a shape where it is right: M a multiple of BK, and
    every block's keys within [lo, lo + WIN) with lo + WIN <= TPAD. There it
    is the segment sum of the bf16-rounded values, as sorted_segment_sum
    with round_bf16 computes it."""
    M, F, BK, WIN, TPAD = 8192, 8, 2048, 2048, 4096

    def seg_kernel(si_ref, sv_ref, out_ref):
        b = pl.program_id(0)

        @pl.when(b == 0)
        def _():
            out_ref[:] = jnp.zeros_like(out_ref)

        ix = si_ref[:]                               # [BK] int32 sorted
        vals = sv_ref[:]                             # [BK, F]
        lo = pl.multiple_of((ix[0] // 8) * 8, 8)
        col = jax.lax.broadcasted_iota(jnp.int32, (BK, WIN), 1) + lo
        oh = (ix[:, None] == col).astype(jnp.bfloat16)
        contrib = jax.lax.dot_general(
            oh, vals.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)      # [WIN, F]
        cur = out_ref[pl.ds(lo, WIN), :]
        out_ref[pl.ds(lo, WIN), :] = cur + contrib

    def pallas_seg(si, sv):
        return pl.pallas_call(
            seg_kernel,
            grid=(M // BK,),
            in_specs=[
                pl.BlockSpec((BK,), lambda b: (b,), memory_space=pltpu.VMEM),
                pl.BlockSpec((BK, F), lambda b: (b, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((TPAD, F), lambda b: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((TPAD, F), jnp.float32),
            interpret=True,
        )(si, sv)

    keys = _sorted_keys(rng, M, 2000)
    vals = rng.normal(size=(M, F)).astype(np.float32)
    ref = np.asarray(pallas_seg(jnp.asarray(keys), jnp.asarray(vals)))
    got = primitives.sorted_segment_sum(torch.tensor(keys),
                                        torch.tensor(vals), TPAD,
                                        round_bf16=True).numpy()
    assert _rel_err(got, ref) < 1e-6


def test_p4_body_interpret_matches_row_cumsum(rng):
    """P4 (scripts/microbench_primitives.py:258-290), body copied verbatim,
    in interpret mode at M a multiple of CB: on the CPU the f32 triangular
    matmul is exact-precision, so it is the row cumsum; 1e-5 of max|ref|."""
    M, F, CB = 4096, 8, 1024
    tri = jnp.tril(jnp.ones((CB, CB), jnp.float32))

    def cs_kernel(v_ref, tri_ref, out_ref, carry_ref):
        b = pl.program_id(0)

        @pl.when(b == 0)
        def _():
            carry_ref[:] = jnp.zeros_like(carry_ref)

        v = v_ref[:]
        c = jax.lax.dot_general(
            tri_ref[:], v, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32) + carry_ref[:]
        out_ref[:] = c
        carry_ref[:] = c[CB - 1:CB, :]

    def pallas_cumsum(v):
        return pl.pallas_call(
            cs_kernel,
            grid=(M // CB,),
            in_specs=[
                pl.BlockSpec((CB, F), lambda b: (b, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((CB, CB), lambda b: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((CB, F), lambda b: (b, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((M, F), jnp.float32),
            scratch_shapes=[pltpu.VMEM((1, F), jnp.float32)],
            interpret=True,
        )(v, tri)

    x = rng.normal(size=(M, F)).astype(np.float32)
    ref = np.asarray(pallas_cumsum(jnp.asarray(x)))
    got = primitives.row_cumsum(torch.tensor(x)).numpy()
    assert _rel_err(got, ref) < primitives.CUMSUM_TOL


# ------------------------------------------------------------------ remix
def test_remix_matches_the_jax_formula(rng):
    """remix restated from scripts/microbench_primitives.py:47-50 (int32
    times a uint32 prime, wrapped to uint32, mod `mod`), on keys across the
    int32 range."""
    def jax_remix(ix, mod):
        return ((ix * np.uint32(PRIME)).astype(jnp.uint32)
                % np.uint32(mod)).astype(jnp.int32)

    ix = np.concatenate([rng.integers(0, 2 ** 31 - 1, 4000),
                         [0, 1, 2 ** 31 - 1, 201_000]]).astype(np.int32)
    for mod in (201_000, 65_536, 4913, 25_125):
        ref = np.asarray(jax_remix(jnp.asarray(ix), mod))
        got = mb.remix(torch.tensor(ix), mod).numpy()
        np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------- the row functions
def test_take_and_gather_rows(rng):
    tbl = torch.tensor(rng.normal(size=(300, 8)), dtype=torch.float32)
    ix = torch.tensor(rng.integers(0, 300, 5000), dtype=torch.int32)
    acc0 = torch.zeros(())
    nix, acc = mb.take_step(tbl)((ix, acc0))
    assert torch.equal(nix, mb.remix(ix, 300))
    torch.testing.assert_close(acc, tbl[ix.long(), 0].sum())
    lvl = mb.level_table(tbl, 64)
    assert lvl.shape == (64, 8) and lvl.dtype == torch.bfloat16
    assert torch.equal(lvl[16:32], lvl[:16])
    nix, acc = mb.gather_step(lvl)((ix % 64, acc0))
    assert torch.equal(nix, mb.remix(ix % 64, 64))
    assert float(acc) == float(lvl[int(ix[0]) % 64].float().sum())
    pair = mb2.pair_table(tbl)
    assert torch.equal(pair[:-1, 8:], tbl[1:]) and torch.equal(pair[-1, 8:],
                                                              tbl[0])


@pytest.mark.parametrize("copies", [1, 2])
def test_vsort_and_ksort_rows(rng, copies):
    ix = torch.tensor(rng.integers(0, 97, 5000), dtype=torch.int32)
    p = mb.pack_bf16_pairs(torch.tensor(rng.normal(size=(5000, 8)),
                                        dtype=torch.float32))
    assert p.shape == (5000, 4) and p.dtype == torch.int32
    order = np.argsort(ix.numpy(), kind="stable")
    nix, sp = mb.vsort_step(97, copies)((ix, p))
    assert torch.equal(sp, p[order])
    assert torch.equal(nix, mb.remix(torch.tensor(ix.numpy()[order]), 97))
    nk, = mb.ksort_step(97)((ix,))
    s = torch.tensor(ix.numpy()[order]) ^ torch.tensor(order,
                                                       dtype=torch.int32)
    assert torch.equal(nk, mb.remix(s, 97))


def test_merge_rank_row(rng):
    """The merge-rank row's ub[0] is the number of keys <= 0."""
    t = 300
    si = torch.sort(torch.tensor(rng.integers(0, t, 5000),
                                 dtype=torch.int32)).values
    out, = mb.merge_rank_step(t)((si,))
    ub0 = int((si <= 0).sum())
    assert torch.equal(out, torch.sort(mb.remix(si ^ ub0, t)).values)


def test_scan_rows(rng):
    v = torch.tensor(rng.normal(size=(5000, 8)), dtype=torch.float32)
    total = v.double().sum(0).float()
    for step in (mb.cumsum_step, mb.row_cumsum_step):
        out, = step((v,))
        torch.testing.assert_close(out, v + total * 1e-9)


@pytest.mark.parametrize("round_bf16", [True, False])
def test_segment_rows(rng, round_bf16):
    t = 300
    ix = torch.tensor(rng.integers(0, t, 5000), dtype=torch.int32)
    v = torch.tensor(rng.normal(size=(5000, 8)), dtype=torch.float32)
    si = torch.sort(ix).values
    nsi, sv = mb.segment_step(t, round_bf16=round_bf16)((si, v))
    assert torch.equal(nsi, torch.sort(mb.remix(si, t)).values)
    first = v[si == 0]
    if round_bf16:
        first = first.bfloat16().float()
    torch.testing.assert_close(sv, v + first.sum(0) * 1e-9)
    nix, dv = mb.dense_segment_sum_step(t)((ix, v))
    assert torch.equal(nix, mb.remix(ix, t))
    torch.testing.assert_close(
        dv, v + v[ix == 0].bfloat16().float().sum(0) * 1e-9)
    assert mb.tpad(201_000) == 201_088


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_one_hot_row(rng, dtype):
    """The one-hot product is the segment sum of the dtype-rounded values
    (torch's bf16 product returns bf16: compared at bf16's resolution)."""
    t0, width = 49, 64
    ix = torch.tensor(rng.integers(0, t0, 5000), dtype=torch.int32)
    v = torch.tensor(rng.normal(size=(5000, 8)), dtype=torch.float32)
    oh = mb.one_hot(ix, width, dtype)
    assert oh.dtype == dtype and torch.equal(oh.float().sum(1),
                                             torch.ones(5000))
    ref = primitives.sorted_segment_sum_plain(ix, v.to(dtype).float(), width,
                                              round_bf16=False)
    got = torch.matmul(oh.t(), v.to(dtype)).float()
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-6
    assert _rel_err(got.numpy(), ref.numpy()) < tol
    nix, nv = mb.one_hot_step(t0, width, dtype)((ix, v))
    assert torch.equal(nix, mb.remix(ix, t0))
    assert nv.shape == v.shape and bool(torch.isfinite(nv).all())


def test_scripts_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mb.main(["--quick"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        mb2.main([])


# ------------------------------------------------------------ the wrappers
def test_wrappers_refuse_what_the_kernels_do_not_take():
    tbl = torch.zeros((64, 8), dtype=torch.bfloat16)
    ix = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        primitives.gather_rows(tbl.half(), ix)
    with pytest.raises(TypeError):
        primitives.gather_rows(tbl, ix.short())
    with pytest.raises(TypeError):
        primitives.gather_rows(tbl.double(), ix.long())
    with pytest.raises(ValueError, match="contiguous"):
        primitives.gather_rows(tbl[:, ::2], ix)
    with pytest.raises(ValueError):
        primitives.gather_rows(tbl[0], ix)
    vals = torch.zeros((10, 8))
    with pytest.raises(TypeError):
        primitives.sorted_segment_sum(ix, vals.double(), 4, round_bf16=False)
    with pytest.raises(ValueError):
        primitives.sorted_segment_sum(ix[:5], vals, 4, round_bf16=False)
    with pytest.raises(ValueError, match="contiguous"):
        primitives.sorted_segment_sum(ix, vals.t().contiguous().t(), 4,
                                      round_bf16=True)
    with pytest.raises(TypeError):
        primitives.row_cumsum(vals.bfloat16())
    with pytest.raises(ValueError):
        primitives.row_cumsum(torch.zeros((10, 257)))
    with pytest.raises(ValueError, match="contiguous"):
        primitives.row_cumsum(torch.zeros((8, 10)).t())


def test_cpu_tensors_take_the_plain_versions(rng):
    """On CPU tensors no kernel is launched, and ragged and empty shapes
    come back with the plain versions' shapes."""
    before = kernels.launch_counts()
    tbl = torch.tensor(rng.normal(size=(64, 8)), dtype=torch.float32)
    for m in (0, 1, 2049):
        ix = torch.tensor(rng.integers(0, 64, m), dtype=torch.int32)
        assert primitives.gather_rows(tbl, ix).shape == (m, 8)
        si = torch.sort(ix).values
        v = torch.ones((m, 8))
        out = primitives.sorted_segment_sum(si, v, 64, round_bf16=True)
        assert out.shape == (64, 8) and float(out.sum()) == 8 * m
        assert primitives.row_cumsum(v).shape == (m, 8)
    assert kernels.launch_counts() == before
