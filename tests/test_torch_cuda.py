"""The port's CUDA kernels against their plain PyTorch versions on the
card. Skipped without one. This file imports neither jax nor the JAX
package, so it also runs where jax is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from naruto_tpu_torch.ops import kernels, primitives, segment


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,ka,kb", [(512, 8, 8), (4608, 8, 4), (4608, 2, 2),
                                     (493_568, 8, 8)])
def test_kernels_match_plain_on_card(gen, cuda_device, m, ka, kb):
    """K2 and K1 against their plain versions on the same card tensors.
    Both round each product to bf16 the same way; K2's f32 sums run in
    another order than the plain reduction, hence 1e-6 of max|ref|."""
    sa = torch.tensor(gen.normal(size=(m, ka)), dtype=torch.bfloat16,
                      device=cuda_device)
    sb = torch.tensor(gen.normal(size=(m, kb)), dtype=torch.bfloat16,
                      device=cuda_device)
    n0 = kernels.launch_counts()
    tot = kernels.chunk_totals(sa, sb)
    ref_tot = kernels.chunk_totals_plain(sa, sb)
    offs = torch.cumsum(ref_tot, 0) - ref_tot
    out = kernels.outer_cumsum(sa, sb, offs)
    ref = kernels.outer_cumsum_plain(sa, sb, offs)
    torch.cuda.synchronize()
    n1 = kernels.launch_counts()
    assert n1["chunk_totals"] == n0["chunk_totals"] + 1
    assert n1["outer_cumsum"] == n0["outer_cumsum"] + 1
    for got, want in ((tot, ref_tot), (out, ref)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-6, err


@pytest.mark.cuda
def test_wrapper_refuses_noncontiguous_on_card(cuda_device):
    sa = torch.zeros((512, 16), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.chunk_totals(sa[:, ::2], sa[:, :8].contiguous())


@pytest.mark.cuda
def test_segment_sum_on_card_matches_host(gen, cuda_device):
    """The same segment sum through the kernels on the card and through
    the plain versions on the host: identical sort and bf16 terms, f32
    sums in another order, so 2e-6 of max|cumsum|."""
    n, L, per, kb = 2000, 4, 4000, 8
    idx = (gen.integers(0, per, (n, L))
           + np.arange(L)[None, :] * per).astype(np.int32)
    frac = gen.uniform(0, 1, (n, L, 3)).astype(np.float32)
    b = gen.normal(size=(n, L * kb)).astype(np.float32)
    args = (torch.tensor(idx), torch.tensor(frac), torch.tensor(b))
    ref = segment.dense_segment_sum_outer_level_major_frac(*args, L * per)
    got = segment.dense_segment_sum_outer_level_major_frac(
        *(a.to(cuda_device) for a in args), L * per).cpu()
    scale = float(torch.cumsum(ref, 0).abs().max())
    assert float((got - ref).abs().max()) < 2e-6 * scale


def _rel(got, ref):
    scale = float(ref.float().abs().max())
    diff = float((got.float() - ref.float()).abs().max())
    return diff / scale if scale else diff


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2049, 5000, 3_000_000])
@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 8),
                                         (torch.bfloat16, 1),
                                         (torch.float32, 8),
                                         (torch.float32, 3),
                                         (torch.bfloat16, 64)])
def test_gather_rows_matches_plain_on_card(gen, cuda_device, m, dtype,
                                           width):
    """gather_rows is a copy: bit-exact against index_select, at ragged M
    and at the scripts' 3M x [65,536, W] shape."""
    tbl = torch.tensor(gen.normal(size=(65_536, width)), dtype=dtype,
                       device=cuda_device)
    idx = torch.tensor(gen.integers(0, 65_536, m), dtype=torch.int32,
                       device=cuda_device)
    n0 = kernels.launch_counts()["gather_rows"]
    got = primitives.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_rows"] == n0 + 1
    assert torch.equal(got, primitives.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
# at 493,568 rows the 2- and 4-byte tables are gathered from shared memory
@pytest.mark.parametrize("m", [1, 7, 2049, 5000, 493_568])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,width", [
    (torch.bfloat16, 1),     # 2-byte rows: 8 rows per 16-byte store
    (torch.bfloat16, 2),     # 4-byte rows
    (torch.int32, 1),        # 4-byte rows (the sort payload column)
    (torch.bfloat16, 8),     # 16-byte rows
    (torch.float32, 8),      # 32-byte rows (the uncertainty grid's cells)
    (torch.bfloat16, 64),    # 128-byte rows (the hash grid's table)
    (torch.float32, 64),     # 256-byte rows (the scan's boundary rows)
    (torch.int32, 3)])       # 12-byte rows: the generic instantiation
def test_gather_rows_widths_and_index_types_on_card(gen, cuda_device, m,
                                                    idx_dtype, dtype, width):
    """Every row width the BA path gathers, int32 tables and int64 indices:
    bit-exact against index_select at ragged M."""
    ts = 4099
    if dtype == torch.int32:
        src = gen.integers(-2 ** 31, 2 ** 31, (ts, width))
    else:
        src = gen.normal(size=(ts, width))
    tbl = torch.tensor(src, dtype=dtype, device=cuda_device)
    idx = torch.tensor(gen.integers(0, ts, m), dtype=idx_dtype,
                       device=cuda_device)
    n0 = kernels.launch_counts()["gather_rows"]
    got = primitives.gather_rows(tbl, idx)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["gather_rows"] == n0 + 1
    assert torch.equal(got, primitives.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2049, 50_000])   # 50,000: the staged table
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 1),
                                         (torch.bfloat16, 8),
                                         (torch.float32, 8),
                                         (torch.bfloat16, 64)])
def test_gather_rows_misaligned_bases_on_card(gen, cuda_device, m, idx_dtype,
                                              dtype, width):
    """A table and indices that start one element into their storage (so
    off the 16-byte boundary the vector paths need) still gather exactly,
    read from device memory or from a copy in shared memory."""
    ts = 3001
    flat = torch.tensor(gen.normal(size=ts * width + 1), dtype=dtype,
                        device=cuda_device)
    tbl = flat[1:].view(ts, width)
    idx = torch.tensor(gen.integers(0, ts, m + 1), dtype=idx_dtype,
                       device=cuda_device)[1:]
    assert tbl.data_ptr() % 16 and idx.data_ptr() % 16
    got = primitives.gather_rows(tbl, idx)
    assert torch.equal(got, primitives.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("m,nf", [(1, 8), (964, 64), (5000, 3),
                                  (93_568, 8), (3_000_000, 8)])
def test_row_cumsum_is_deterministic_on_card(gen, cuda_device, m, nf):
    """Two calls on the same input agree bit for bit, with a call of
    another shape between them: every sum runs in an order fixed by the
    shape, never by which block finished first."""
    x = torch.tensor(gen.normal(size=(m, nf)), dtype=torch.float32,
                     device=cuda_device)
    other = torch.ones((4097, 5), device=cuda_device)
    first = primitives.row_cumsum(x)
    primitives.row_cumsum(other)
    second = primitives.row_cumsum(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_row_cumsum_is_one_launch_on_card(cuda_device):
    """One kernel, and nothing else on the device (no memset, no copy), per
    call at every M, as the profiler records it."""
    from torch.profiler import ProfilerActivity, profile

    xs = [torch.ones((m, nf), device=cuda_device)
          for m, nf in ((1, 8), (964, 64), (93_568, 8), (3_000_000, 8),
                        (3000, 256))]
    for x in xs:                       # the first calls size the state
        primitives.row_cumsum(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs:
            primitives.row_cumsum(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == len(xs), names
    assert all("row_cumsum" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("m,size,nf", [(1, 4000, 8), (2049, 4000, 8),
                                       (5000, 4000, 8), (5000, 300, 3),
                                       (3_000_000, 201_088, 8)])
def test_sorted_segment_sum_matches_plain_on_card(gen, cuda_device,
                                                  round_bf16, m, size, nf):
    """Sorted keys with empty slots and the key size-1; the plain
    index_add_ sums through atomics in a varying order, so SEGMENT_TOL."""
    keys = gen.integers(0, size, m)
    keys[-1] = size - 1
    si = torch.tensor(np.sort(keys), dtype=torch.int32, device=cuda_device)
    vals = torch.tensor(gen.normal(size=(m, nf)), dtype=torch.float32,
                        device=cuda_device)
    n0 = kernels.launch_counts()["sorted_segment_sum"]
    got = primitives.sorted_segment_sum(si, vals, size,
                                        round_bf16=round_bf16)
    ref = primitives.sorted_segment_sum_plain(si, vals, size,
                                              round_bf16=round_bf16)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sorted_segment_sum"] == n0 + 1
    assert _rel(got, ref) <= primitives.SEGMENT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m,nf", [(1, 8), (2049, 8), (5000, 8), (5000, 1),
                                  (5000, 3), (70_000, 64), (3000, 256),
                                  (3_000_000, 8)])
def test_row_cumsum_matches_plain_on_card(gen, cuda_device, m, nf):
    x = torch.tensor(gen.normal(size=(m, nf)), dtype=torch.float32,
                     device=cuda_device)
    n0 = kernels.launch_counts()["row_cumsum"]
    got = primitives.row_cumsum(x)
    ref = primitives.row_cumsum_plain(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["row_cumsum"] == n0 + 1
    assert _rel(got, ref) <= primitives.CUMSUM_TOL


@pytest.mark.cuda
def test_primitive_wrappers_refuse_on_card(cuda_device):
    tbl = torch.zeros((64, 8), dtype=torch.bfloat16, device=cuda_device)
    ix = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    vals = torch.zeros((16, 8), device=cuda_device)
    with pytest.raises(TypeError):
        primitives.gather_rows(tbl.half(), ix)
    with pytest.raises(ValueError, match="contiguous"):
        primitives.gather_rows(tbl[:, ::2], ix)
    with pytest.raises(ValueError):
        primitives.gather_rows(tbl, ix.cpu())
    with pytest.raises(TypeError):
        primitives.sorted_segment_sum(ix, vals.bfloat16(), 4,
                                      round_bf16=False)
    with pytest.raises(ValueError, match="contiguous"):
        primitives.sorted_segment_sum(ix[::2], vals[::2], 4,
                                      round_bf16=False)
    with pytest.raises(TypeError):
        primitives.row_cumsum(vals.double())
    with pytest.raises(ValueError, match="contiguous"):
        primitives.row_cumsum(vals.t())


@pytest.mark.cuda
def test_primitives_launch_nothing_for_empty_outputs(cuda_device):
    """An empty output launches nothing; no updates into 5 slots is a
    launch that writes zeros (the kernel needs no memset)."""
    before = kernels.launch_counts()
    tbl = torch.zeros((64, 8), dtype=torch.bfloat16, device=cuda_device)
    ix = torch.zeros(0, dtype=torch.int32, device=cuda_device)
    none = torch.zeros((0, 8), device=cuda_device)
    assert primitives.gather_rows(tbl, ix).shape == (0, 8)
    assert primitives.sorted_segment_sum(ix, none, 0,
                                         round_bf16=True).shape == (0, 8)
    assert primitives.row_cumsum(none).shape == (0, 8)
    assert kernels.launch_counts() == before
    out = primitives.sorted_segment_sum(ix, none, 5, round_bf16=True)
    torch.cuda.synchronize()
    assert out.shape == (5, 8) and not bool(out.any())
