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


def _only_kernel(calls, kernel: str) -> None:
    """Runs `calls` once each under the profiler and asserts that the
    device saw one `kernel` per call and nothing else (no memset, no
    copy). The tracer loses a session's first kernel in a process that has
    run much before, so a launch that does not count goes first; and it
    drops other records now and then, several traces on end, so a trace
    that is short is taken again half a second later, up to five times:
    one of them must show exactly one event per call. A call that launches
    nothing is short every time, and fails."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from naruto_tpu_torch.scripts.trace_summary import (LEAD_KERNEL,
                                                        lead_launch)

    for fn in calls:                   # the first calls size the state
        fn()
    lead = torch.empty(1, dtype=torch.int8, device="cuda")
    torch.cuda.synchronize()
    seen = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead_launch(lead)
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and LEAD_KERNEL not in e.name]
        assert all(kernel in n for n in names), names
        assert len(names) <= len(calls), names
        if len(names) == len(calls):
            return
        seen.append(len(names))
        time.sleep(0.5)
    raise AssertionError(f"no trace of 5 shows {len(calls)} launches of "
                         f"{kernel}: {seen}")


INT32_MAX = 2 ** 31 - 1
# (name, real rows, size, ka, kb): office0's shape (493,436 updates padded
# to 493,568 rows, 204,089 slots) and key layouts that stress the slot
# rows' scatter rule; real rows not a multiple of 512 get INT32_MAX pads
SCAN_CASES = [
    ("uniform", 493_436, 204_089, 8, 8),
    ("uniform", 512, 300, 8, 8),
    ("uniform", 4608, 3000, 8, 4),
    ("uniform", 4608, 3000, 2, 2),
    ("first_key_late", 4100, 9000, 8, 8),
    ("last_key_early", 4608, 9000, 8, 8),
    ("long_gaps", 5000, 200_000, 8, 8),
    ("one_key_spans_chunks", 6144, 3000, 8, 8),
]


def _scan_inputs(gen, dev, name, n, size, ka, kb):
    if name == "uniform":
        keys = gen.integers(0, size, n)
    elif name == "first_key_late":
        keys = gen.integers(size // 2, size, n)
    elif name == "last_key_early":
        keys = gen.integers(0, size // 3, n)
    elif name == "long_gaps":
        keys = np.concatenate([gen.integers(0, 5, n // 3),
                               gen.integers(90_000, 90_010, n // 3),
                               gen.integers(size - 3, size, n - 2 * (n // 3))])
    else:                                   # one key over >= 3 chunks
        keys = np.concatenate([gen.integers(0, 1000, 1000),
                               np.full(2000, 1500),
                               gen.integers(1501, size, n - 3000)])
    pad = (-n) % 512
    si = torch.tensor(np.concatenate([np.sort(keys), np.full(pad, INT32_MAX)]),
                      dtype=torch.int32, device=dev)
    m = n + pad
    sa = torch.tensor(gen.normal(size=(m, ka)), dtype=torch.bfloat16,
                      device=dev)
    sb = torch.tensor(gen.normal(size=(m, kb)), dtype=torch.bfloat16,
                      device=dev)
    sa[n:] = 0
    sb[n:] = 0
    return si, sa, sb


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,size,ka,kb", SCAN_CASES)
def test_kernels_match_plain_on_card(gen, cuda_device, name, n, size, ka,
                                     kb):
    """Both epilogues of the fused scan against their plain versions on the
    same card tensors, one launch each. Both round each product to bf16 the
    same way; the f32 sums run in another order than the plain cumsums,
    hence 1e-6 of max|plain|. The slot rows are the full rows at each
    slot's last update, bit for bit."""
    si, sa, sb = _scan_inputs(gen, cuda_device, name, n, size, ka, kb)
    n0 = kernels.launch_counts()
    rows = kernels.outer_cumsum_scan(sa, sb)
    hi = kernels.outer_cumsum_slots(si, sa, sb, size)
    torch.cuda.synchronize()
    n1 = kernels.launch_counts()
    assert n1["outer_scan_rows"] == n0["outer_scan_rows"] + 1
    assert n1["outer_scan_slots"] == n0["outer_scan_slots"] + 1
    for got, want in ((rows, kernels.outer_cumsum_scan_plain(sa, sb)),
                      (hi, kernels.outer_cumsum_slots_plain(si, sa, sb,
                                                            size))):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-6
    ub = torch.searchsorted(si, torch.arange(size, dtype=torch.int32,
                                             device=cuda_device), right=True)
    at_last = torch.where((ub > 0)[:, None],
                          rows.index_select(0, (ub - 1).clamp(min=0)), 0.0)
    assert torch.equal(hi, at_last)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,size,ka,kb", SCAN_CASES[:2] + SCAN_CASES[6:])
def test_outer_scan_is_deterministic_on_card(gen, cuda_device, name, n, size,
                                             ka, kb):
    """Two calls of each epilogue on the same input agree bit for bit, with
    a row_cumsum call (which shares the look-back state) between them."""
    si, sa, sb = _scan_inputs(gen, cuda_device, name, n, size, ka, kb)
    other = torch.ones((4097, 5), device=cuda_device)
    first = (kernels.outer_cumsum_scan(sa, sb),
             kernels.outer_cumsum_slots(si, sa, sb, size))
    primitives.row_cumsum(other)
    second = (kernels.outer_cumsum_scan(sa, sb),
              kernels.outer_cumsum_slots(si, sa, sb, size))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_outer_scan_is_one_launch_on_card(gen, cuda_device):
    """Each call of either epilogue is one kernel and nothing else on the
    device (no memset, no copy), as the profiler records it."""
    inputs = [_scan_inputs(gen, cuda_device, *case) for case in SCAN_CASES]
    calls = [fn for (name, n, size, ka, kb), (si, sa, sb)
             in zip(SCAN_CASES, inputs)
             for fn in (lambda sa=sa, sb=sb: kernels.outer_cumsum_scan(sa, sb),
                        lambda si=si, sa=sa, sb=sb, size=size:
                        kernels.outer_cumsum_slots(si, sa, sb, size))]
    _only_kernel(calls, "outer_scan")


@pytest.mark.cuda
def test_wrapper_refuses_noncontiguous_on_card(cuda_device):
    """f32 factors, an M that is not a multiple of 512 and non-contiguous
    operands are refused before any launch."""
    sa = torch.zeros((512, 16), dtype=torch.bfloat16, device=cuda_device)
    si = torch.zeros(1024, dtype=torch.int32, device=cuda_device)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="contiguous"):
        kernels.outer_cumsum_scan(sa[:, ::2], sa[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.outer_cumsum_slots(si[::2], sa[:, :8].contiguous(),
                                   sa[:, 8:].contiguous(), 4)
    with pytest.raises(TypeError):
        kernels.outer_cumsum_slots(si[:512], sa[:, :8].float(),
                                   sa[:, 8:].float(), 4)
    with pytest.raises(ValueError, match="multiple of 512"):
        kernels.outer_cumsum_scan(sa[:500, :8].contiguous(),
                                  sa[:500, 8:].contiguous())
    assert kernels.launch_counts() == before


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
    xs = [torch.ones((m, nf), device=cuda_device)
          for m, nf in ((1, 8), (964, 64), (93_568, 8), (3_000_000, 8),
                        (3000, 256))]
    _only_kernel([lambda x=x: primitives.row_cumsum(x) for x in xs],
                 "row_cumsum")


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


# (layout, rows, slots, columns). At 8 columns a tile has 512 rows below
# ~1M rows and 2,048 rows at 3M, so 4607 / 4609 and 2,998,271 / 2,998,273
# are one less / one more than a multiple of the tile.
SEGMENT_CASES = [
    ("ba_cells", 93_568, 89_760, 8),
    ("uniform", 4607, 3000, 8),
    ("uniform", 4609, 3000, 8),
    ("uniform", 2_998_271, 201_088, 8),
    ("uniform", 2_998_273, 201_088, 8),
    ("dominant_key", 300_000, 5000, 8),
    ("dominant_key", 3_000_000, 201_088, 8),
    ("single_key", 70_000, 9, 8),
    ("first_key_late", 20_000, 9000, 8),
    ("last_key_early", 20_000, 9000, 8),
    ("long_gaps", 5000, 200_000, 8),
    ("out_of_range", 30_000, 4000, 8),
    ("uniform", 5000, 300, 1),
    ("uniform", 5000, 300, 12),
    ("dominant_key", 40_000, 300, 3),
    ("uniform", 20_000, 3000, 64),
    ("dominant_key", 9000, 50, 300),     # two column blocks, scalar path
    ("uniform", 9000, 500, 512),         # two column blocks, 16-byte path
]


EXACT_LAYOUTS = ("dominant_key", "single_key", "long_gaps")


def _segment_inputs(gen, dev, name, m, size, nf):
    """Sorted int32 keys and f32 values of a layout. The layouts with long
    runs get small integer values: their sums are exact in any order, where
    the plain version's atomics over many terms would drift."""
    if name == "ba_cells":
        # 2,176 rays x 43 samples through the unit cube, in the cells of a
        # (49, 56, 35) grid, as the BA's trilinear VJP keys them
        o = gen.uniform(0.3, 0.7, (m // 43, 1, 3))
        d = gen.normal(size=(m // 43, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.linspace(0.0, 0.4, 43)[None, :, None]
        p = np.clip(o + d * t, 0.0, 1.0).reshape(-1, 3)
        c = np.minimum((p * [48, 55, 34]).astype(np.int64), [47, 54, 33])
        keys = c[:, 0] * (55 * 34) + c[:, 1] * 34 + c[:, 2]
    elif name == "uniform":
        keys = gen.integers(0, size, m)
    elif name == "dominant_key":
        keys = np.concatenate([gen.integers(0, size, m - (m * 3) // 5),
                               np.full((m * 3) // 5, size // 3)])
    elif name == "single_key":
        keys = np.full(m, 4)
    elif name == "first_key_late":
        keys = gen.integers(size // 2, size, m)
    elif name == "last_key_early":
        keys = gen.integers(0, size // 3, m)
    elif name == "long_gaps":
        keys = np.concatenate([gen.integers(0, 5, m // 3),
                               gen.integers(90_000, 90_010, m // 3),
                               gen.integers(size - 3, size, m - 2 * (m // 3))])
    else:                                   # out_of_range
        keys = np.concatenate([gen.integers(-500, 0, m // 4),
                               gen.integers(0, size, m // 2),
                               gen.integers(size, size + 500,
                                            m - m // 4 - m // 2)])
    assert keys.shape == (m,)
    if name in EXACT_LAYOUTS:
        vals = gen.integers(-4, 5, (m, nf))
    else:
        vals = gen.normal(size=(m, nf))
    return (torch.tensor(np.sort(keys), dtype=torch.int32, device=dev),
            torch.tensor(vals, dtype=torch.float32, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("name,m,size,nf", SEGMENT_CASES)
def test_sorted_segment_sum_layouts_on_card(gen, cuda_device, name, m, size,
                                            nf, round_bf16):
    """The BA's shape and key layouts that stress the tiling (one key over
    most of the rows, so over many tiles; empty leading and trailing slots;
    long gaps; keys outside [0, size), which are dropped; M beside a tile
    multiple; other column counts) against the plain version on the same
    card tensors within SEGMENT_TOL; one launch counted; and a second call,
    with a row_cumsum (which shares the look-back state) between them,
    gives the same bits."""
    si, vals = _segment_inputs(gen, cuda_device, name, m, size, nf)
    n0 = kernels.launch_counts()["sorted_segment_sum"]
    got = primitives.sorted_segment_sum(si, vals, size,
                                        round_bf16=round_bf16)
    assert kernels.launch_counts()["sorted_segment_sum"] == n0 + 1
    primitives.row_cumsum(torch.ones((4097, 5), device=cuda_device))
    again = primitives.sorted_segment_sum(si, vals, size,
                                          round_bf16=round_bf16)
    keep = (si >= 0) & (si < size)
    ref = primitives.sorted_segment_sum_plain(
        si[keep], vals[keep].contiguous(), size, round_bf16=round_bf16)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, ref) <= primitives.SEGMENT_TOL
    if name in EXACT_LAYOUTS:
        assert torch.equal(got, ref)        # exact sums: bit for bit


@pytest.mark.cuda
def test_sorted_segment_sum_misaligned_base_on_card(gen, cuda_device):
    """Values that start one element into their storage (off the 16-byte
    boundary of the vector path) are summed by the scalar path."""
    m, size, nf = 5000, 700, 8
    si, _ = _segment_inputs(gen, cuda_device, "uniform", m, size, nf)
    flat = torch.tensor(gen.normal(size=m * nf + 1), dtype=torch.float32,
                        device=cuda_device)
    vals = flat[1:].view(m, nf)
    assert vals.data_ptr() % 16
    got = primitives.sorted_segment_sum(si, vals, size, round_bf16=False)
    ref = primitives.sorted_segment_sum_plain(si, vals, size,
                                              round_bf16=False)
    assert _rel(got, ref) <= primitives.SEGMENT_TOL


@pytest.mark.cuda
def test_sorted_segment_sum_is_one_launch_on_card(gen, cuda_device):
    """One kernel, and nothing else on the device (no memset, no copy), per
    call at up to 256 columns, as the profiler records it."""
    cases = [c for c in SEGMENT_CASES if c[3] <= 256 and c[1] <= 300_000]
    inputs = [_segment_inputs(gen, cuda_device, *c) for c in cases]
    calls = [lambda si=si, v=v, size=c[2]: primitives.sorted_segment_sum(
        si, v, size, round_bf16=False) for c, (si, v) in zip(cases, inputs)]
    _only_kernel(calls, "segment_sum")


@pytest.mark.cuda
def test_trilinear_vjp_on_card_matches_host(gen, cuda_device):
    """The uncertainty grid's volume gradient through the kernels on the
    card and through the plain versions on the host: the same f32 terms,
    per-cell sums in another order, so 1e-6 of max|d_vol|."""
    from naruto_tpu_torch.ops.grid_sample import trilinear_sample

    vol = torch.tensor(gen.normal(size=(49, 56, 35)), dtype=torch.float32)
    pts = torch.tensor(0.3 + 0.4 * gen.uniform(size=(93_568, 3)),
                       dtype=torch.float32)
    g = torch.tensor(gen.normal(size=93_568), dtype=torch.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        v = vol.to(dev).requires_grad_(True)
        out = trilinear_sample(v, pts.to(dev))
        grads.append(torch.autograd.grad(out, v, g.to(dev))[0].cpu())
    assert _rel(grads[1], grads[0]) <= 1e-6


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
