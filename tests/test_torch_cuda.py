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
@pytest.mark.parametrize("where", ["small", "office0"])
def test_segment_sum_on_card_matches_host(gen, cuda_device, where):
    """The same segment sum through the kernels on the card and through
    the plain versions on the host: identical sort and bf16 terms, f32
    sums in another order, so 2e-6 of max|cumsum|. Small: 2,000 x 4
    updates; office0: the mapping step's, 123,359 points in the cells of
    office0's hybrid grid (493,436 updates into 204,089 table rows), on
    the draws this check has always had there (a torch generator seeded
    1). The bound is empirical: the slot rows are differences of prefix
    sums over all M rows, whose rounding grows with M."""
    if where == "small":
        n, L, per, kb = 2000, 4, 4000, 8
        idx = torch.tensor((gen.integers(0, per, (n, L))
                            + np.arange(L)[None, :] * per).astype(np.int32))
        frac = torch.tensor(gen.uniform(0, 1, (n, L, 3)), dtype=torch.float32)
        b = torch.tensor(gen.normal(size=(n, L * kb)), dtype=torch.float32)
        size = L * per
    else:
        from naruto_tpu_torch.config import make_config
        from naruto_tpu_torch.mapping.mapper import field_spec_from_config
        from naruto_tpu_torch.ops.encoding import _cell_indices, _cell_pos

        spec = field_spec_from_config(
            make_config("Replica", "office0")).hash_spec
        n, L, kb = 123_359, spec.n_levels, spec.n_features
        draws = torch.Generator().manual_seed(1)
        x = torch.rand((n, 3), generator=draws)
        idx, frac = _cell_indices(x, spec)[0], _cell_pos(x, spec)[1]
        b = torch.randn((n, L * kb), generator=draws) * 1e-3
        size = spec.total_entries
    args = (idx, frac, b)
    ref = segment.dense_segment_sum_outer_level_major_frac(*args, size)
    got = segment.dense_segment_sum_outer_level_major_frac(
        *(a.to(cuda_device) for a in args), size).cpu()
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
    elif name == "vertex":
        # the parity grid's corner rows of points along rays: the vertex
        # backward's keys at office0
        from naruto_tpu_torch.scripts.probe_segment_sum import vertex_keys

        keys = vertex_keys(dev)[0].cpu().numpy()
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


# sorted_segment_sum fed a sort permutation: (layout, rows, slots, columns).
# F = 2 is the vertex backward's (bf16-rounded), F = 8 the trilinear VJP's
# (exact f32). 3 x 4,096 and 3 x 2,048 rows are multiples of every tile the
# two widths take, so one less and one more straddle a tile's edge. Last,
# the BA's cells and the vertex backward's own keys at office0.
PERM_CASES = [(name, m, size, nf)
              for nf, tile, big_size in ((2, 4096, 814_897),
                                         (8, 2048, 201_088))
              for name, m, size in (
                  ("uniform", 1, 300), ("uniform", 2049, 4000),
                  ("uniform", 5000, 300), ("uniform", 3 * tile - 1, 3000),
                  ("uniform", 3 * tile + 1, 3000),
                  ("uniform", 1_000_003, big_size),
                  ("dominant_key", 300_000, 5000),
                  ("first_key_late", 20_000, 9000),
                  ("last_key_early", 20_000, 9000),
                  ("long_gaps", 5000, 200_000))] + [
    ("ba_cells", 93_568, 89_760, 8), ("vertex", 15_789_952, 814_897, 2)]


def _permuted(gen, dev, name, m, size, nf, idx_dtype, offset=0):
    """The inputs of a layout as a sort leaves them: sorted keys, the values
    unsorted in a tensor of m + 3 rows (starting `offset` floats into its
    storage), and the permutation whose rows are the layout's values in
    key order."""
    si, vals = _segment_inputs(gen, dev, name, m, size, nf)
    perm = torch.tensor(gen.permutation(m + 3)[:m], device=dev)
    flat = torch.zeros((m + 3) * nf + offset, device=dev)
    unsorted = flat[offset:].view(m + 3, nf)
    unsorted[perm] = vals
    return si, unsorted, perm.to(idx_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("name,m,size,nf", PERM_CASES)
def test_sorted_segment_sum_with_perm_on_card(gen, cuda_device, name, m, size,
                                              nf, idx_dtype):
    """The permutation's form against the pair it replaces (gather_rows by
    the permutation, then the sum of the gathered rows) bit for bit, and
    against the plain version within SEGMENT_TOL (exact where the sums
    are); one launch a call, and two calls give the same bits."""
    rb = nf == 2
    si, vals, perm = _permuted(gen, cuda_device, name, m, size, nf, idx_dtype)
    n0 = kernels.launch_counts()["sorted_segment_sum"]
    got = primitives.sorted_segment_sum(si, vals, size, round_bf16=rb,
                                        perm=perm)
    assert kernels.launch_counts()["sorted_segment_sum"] == n0 + 1
    again = primitives.sorted_segment_sum(si, vals, size, round_bf16=rb,
                                          perm=perm)
    pair = primitives.sorted_segment_sum(
        si, primitives.gather_rows(vals, perm), size, round_bf16=rb)
    ref = primitives.sorted_segment_sum_plain(si, vals, size, round_bf16=rb,
                                              perm=perm)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, pair)
    assert _rel(got, ref) <= primitives.SEGMENT_TOL
    if name in EXACT_LAYOUTS:
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("nf", [2, 8])
def test_sorted_segment_sum_with_perm_misaligned_on_card(gen, cuda_device,
                                                         nf, idx_dtype):
    """Values one float off their alignment: the rows are copied in 4-byte
    pieces, but the tiling is that of the aligned gathered rows, so the
    pair's sums come out bit for bit."""
    si, vals, perm = _permuted(gen, cuda_device, "uniform", 20_000, 3000, nf,
                               idx_dtype, offset=1)
    assert vals.data_ptr() % 8
    got = primitives.sorted_segment_sum(si, vals, 3000, round_bf16=nf == 2,
                                        perm=perm)
    pair = primitives.sorted_segment_sum(
        si, primitives.gather_rows(vals, perm), 3000, round_bf16=nf == 2)
    ref = primitives.sorted_segment_sum_plain(si, vals, 3000,
                                              round_bf16=nf == 2, perm=perm)
    torch.cuda.synchronize()
    assert torch.equal(got, pair)
    assert _rel(got, ref) <= primitives.SEGMENT_TOL


@pytest.mark.cuda
def test_sorted_segment_sum_with_perm_is_one_launch_on_card(gen,
                                                            cuda_device):
    """With the permutation too, one kernel and nothing else on the device
    a call (no gather, no memset), as the profiler records it."""
    cases = [c for c in PERM_CASES if c[1] <= 300_000]
    inputs = [_permuted(gen, cuda_device, *c, torch.int64) for c in cases]
    calls = [lambda si=si, v=v, p=p, size=c[2]: primitives.sorted_segment_sum(
        si, v, size, round_bf16=c[3] == 2, perm=p)
        for c, (si, v, p) in zip(cases, inputs)]
    _only_kernel(calls, "segment_sum")


@pytest.mark.cuda
@pytest.mark.parametrize("nf,pack", [(2, True), (8, False)])
def test_dense_segment_sum_launches_no_gather_on_card(gen, cuda_device, nf,
                                                      pack):
    """dense_segment_sum on the card: one sort and one sorted_segment_sum
    launch, no gather_rows; against the host's result within
    SEGMENT_TOL."""
    idx = torch.tensor(gen.integers(0, 5000, 40_000), device=cuda_device)
    vals = torch.tensor(gen.normal(size=(40_000, nf)), dtype=torch.float32,
                        device=cuda_device)
    before = kernels.launch_counts()
    got = segment.dense_segment_sum(idx, vals, 5000, pack_bf16=pack)
    after = kernels.launch_counts()
    ref = segment.dense_segment_sum(idx.cpu(), vals.cpu(), 5000,
                                    pack_bf16=pack)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == "sorted_segment_sum") for k in after}
    assert _rel(got.cpu(), ref) <= primitives.SEGMENT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("points", ["uniform", "rays"])
def test_trilinear_vjp_on_card_matches_host(gen, cuda_device, points):
    """The uncertainty grid's volume gradient through the kernels on the
    card and through the plain versions on the host: the same f32 terms,
    per-cell sums in another order, so 1e-6 of max|d_vol|. The BA's
    93,568 points: uniform in a box, or 43 along each of 2,176 rays, as
    the BA samples them (crowded on few cells)."""
    from naruto_tpu_torch.ops.grid_sample import trilinear_sample

    vol = torch.tensor(gen.normal(size=(49, 56, 35)), dtype=torch.float32)
    if points == "uniform":
        p = 0.3 + 0.4 * gen.uniform(size=(93_568, 3))
    else:
        o = gen.uniform(0.3, 0.7, (2176, 1, 3))
        d = gen.normal(size=(2176, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = np.clip(o + d * np.linspace(0.0, 0.4, 43)[None, :, None], 0.0,
                    1.0).reshape(-1, 3)
    pts = torch.tensor(p, dtype=torch.float32)
    g = torch.tensor(gen.normal(size=93_568), dtype=torch.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        v = vol.to(dev).requires_grad_(True)
        out = trilinear_sample(v, pts.to(dev))
        grads.append(torch.autograd.grad(out, v, g.to(dev))[0].cpu())
    assert _rel(grads[1], grads[0]) <= 1e-6


# ------------------------------- the uncertainty grid's trilinear sample
TRILERP_GRIDS = {"office0": (49, 56, 35), "jiraiya": (306, 306, 306)}


def _trilerp_inputs(shape, kind: str, seed: int):
    """(vol, coords in voxel units, cotangent) on the card: a BA
    iteration's 93,568 samples, 43 along each of 2,176 rays (crowded on
    few cells), or spread over and past the grid (the clamp's fringe)."""
    rng = np.random.default_rng(seed)
    if kind == "rays":
        o = rng.uniform(0.3, 0.7, (2176, 1, 3))
        d = rng.normal(size=(2176, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        p = np.clip(o + d * np.linspace(0.0, 0.4, 43)[None, :, None], 0.0,
                    1.0).reshape(-1, 3)
    else:
        p = rng.uniform(-0.1, 1.1, (93_568, 3))
    coords = p * np.asarray(shape) - 0.5
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in
            (rng.normal(size=shape), coords, rng.normal(size=p.shape[0]))]


def _trilerp_plain(vol, coords, g):
    """(sample, grid gradient) through the plain versions (the per-cell
    sums are the segment-sum kernel's either way)."""
    from naruto_tpu_torch.ops import grid_sample as gs

    key, w, _, vals = gs.trilerp_forward_plain(vol, coords)
    si, perm = torch.sort(key, stable=True)
    rank = gs.run_ranks(si)
    d_cell = primitives.sorted_segment_sum(rank, g[:, None] * w, g.shape[0],
                                           round_bf16=False, perm=perm)
    return (torch.sum(vals * w, dim=-1),
            gs.trilerp_vjp_plain(tuple(vol.shape), si, rank, d_cell))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rays", "fringe"])
@pytest.mark.parametrize("grid", list(TRILERP_GRIDS))
def test_trilerp_kernels_equal_plain_on_card(cuda_device, grid, kind):
    """csrc/trilerp.cu's forward and vertex sums equal their plain
    versions on the same card tensors bit for bit, one launch each, and
    two calls agree; the sample and the grid gradient equal the dense-pack
    path's (tests/dense_trilerp.py) bit for bit, at jiraiya's 306^3 grid
    and office0's (49, 56, 35)."""
    from dense_trilerp import DenseTrilerp, cell_data, dense_vol_grad

    from naruto_tpu_torch.ops import grid_sample as gs

    shape = TRILERP_GRIDS[grid]
    vol, coords, g = _trilerp_inputs(shape, kind, 11)
    before = kernels.launch_counts()
    got = gs.trilerp_forward(vol, coords)
    for a, b in zip(got, gs.trilerp_forward_plain(vol, coords)):
        assert torch.equal(a, b)
    key, w = got[0], got[1]
    gw = g[:, None] * w
    si, perm = torch.sort(key, stable=True)
    rank = gs.run_ranks(si)
    d_cell = primitives.sorted_segment_sum(rank, gw, g.shape[0],
                                           round_bf16=False, perm=perm)
    d_vol = gs.trilerp_vjp(shape, si, rank, d_cell)
    assert torch.equal(d_vol, gs.trilerp_vjp_plain(shape, si, rank, d_cell))
    assert torch.equal(d_vol, gs.trilerp_vjp(shape, si, rank, d_cell))
    after = kernels.launch_counts()
    assert after["trilerp_forward"] - before["trilerp_forward"] == 1
    assert after["trilerp_vjp"] - before["trilerp_vjp"] == 2
    assert after["gather_rows"] == before["gather_rows"]
    assert torch.equal(torch.sum(got[3] * w, dim=-1),
                       DenseTrilerp.apply(vol, coords))
    assert torch.equal(d_vol, dense_vol_grad(
        shape, cell_data(shape, coords)[0], gw))
    assert 0 < int((d_vol != 0).sum()) <= 8 * (int(rank[-1]) + 1)


@pytest.mark.cuda
def test_trilerp_wrappers_refuse_on_card(cuda_device):
    """The wrappers raise, before any launch, on a grid or samples of
    another dtype, non-contiguous operands and operands on two devices."""
    from naruto_tpu_torch.ops import grid_sample as gs

    vol = torch.zeros((8, 8, 8), device=cuda_device)
    coords = torch.zeros((16, 3), device=cuda_device)
    si = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    d_cell = torch.zeros((16, 8), device=cuda_device)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        gs.trilerp_forward(vol.double(), coords)
    with pytest.raises(TypeError):
        gs.trilerp_forward(vol, coords.half())
    with pytest.raises(ValueError, match="contiguous"):
        gs.trilerp_forward(vol.transpose(0, 2), coords)
    with pytest.raises(ValueError, match="contiguous"):
        gs.trilerp_forward(vol, coords.t().contiguous().t())
    with pytest.raises(ValueError):
        gs.trilerp_forward(vol, coords.cpu())
    with pytest.raises(TypeError):
        gs.trilerp_vjp((8, 8, 8), si.long(), si, d_cell)
    with pytest.raises(TypeError):
        gs.trilerp_vjp((8, 8, 8), si, si, d_cell.double())
    with pytest.raises(ValueError, match="contiguous"):
        gs.trilerp_vjp((8, 8, 8), si, si,
                       torch.zeros((8, 16), device=cuda_device).t())
    assert kernels.launch_counts() == before


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


@pytest.mark.cuda
def test_optimizer_steps_are_one_launch_on_card(cuda_device):
    """Each optimizer's step is one kernel on the device and nothing else
    (no copy, no fill): the table's over its leaves, the decoders' over
    four. Before the graph tests: once a process has captured a graph, the
    tracer loses most records."""
    from naruto_tpu_torch.mapping.optim import Adam, EmbedAdam

    gen = torch.Generator(device=cuda_device).manual_seed(8)
    table = _embed_leaves(cuda_device, gen)
    grads = _embed_grads(cuda_device, gen)
    scal = _card_scalars(EmbedAdam.scalars(3), cuda_device)
    embed = EmbedAdam(table, 1e-2)
    _only_kernel([lambda: embed.step(table, grads, scal[0], scal[1])],
                 "multi_tensor_step")
    shapes = ADAM_GROUPS["decoder"][0][0]
    dec = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
    dgrads = [torch.randn_like(p) for p in dec]
    adam = Adam(dec, 1e-2, (0.9, 0.99), 1e-8, 1e-6)
    dscal = _card_scalars(adam.scalars(3), cuda_device)
    _only_kernel([lambda: adam.step(dgrads, dscal[0], dscal[1])],
                 "multi_tensor_step")


# ------------------------------------------------- extraction, checkpoints
MESH_BOUND = ((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0))
MESH_TINY = {"cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                     "cy": 11.5, "far": 5.0},
             "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
             "mapper": {"sample": 64, "iters": 2, "first_iters": 2,
                        "min_pixels_cur": 4, "act_ray_num_uncert_sample": 8,
                        "bound": MESH_BOUND,
                        "marching_cubes_bound": MESH_BOUND,
                        "voxel_size": 0.5},
             "training": {"n_samples_d": 8, "n_range_d": 5,
                          "smooth_pts": 4}}


@pytest.fixture
def mapper_pair(cuda_device, tmp_path):
    """A host Mapper whose field was fitted to a sphere's SDF (a well
    conditioned isosurface) and a card Mapper that loaded its checkpoint."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.field import query_sdf
    from naruto_tpu_torch.mapping.mapper import Mapper

    cfg = make_config("Replica", "office0", num_iter=10, overrides=MESH_TINY)
    host = Mapper(cfg, device="cpu")
    opt = torch.optim.Adam(host._all_params(), lr=1e-2)
    g = torch.Generator().manual_seed(0)
    for _ in range(80):
        x01 = torch.rand((2048, 3), generator=g)
        target = (torch.linalg.norm(x01 * 2 - 1, dim=-1) - 0.55) * 4
        loss = ((query_sdf(host.params, x01, host.spec) - target)
                ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    path = str(tmp_path / "host.pkl")
    host.save_ckpt(path)
    card = Mapper(cfg, device=cuda_device)
    card.load_ckpt(path)
    return host, card


@pytest.mark.cuda
def test_extract_mesh_on_card_matches_host(mapper_pair):
    """The field's dense query and colours through gather_rows on the card
    give the host's mesh: the same faces, vertices within 1e-3 cm."""
    from naruto_tpu_torch.mesh.extract import _dense_sdf, extract_mesh

    host, card = mapper_pair
    bound = np.asarray(MESH_BOUND, np.float32)
    sh, uh, _ = _dense_sdf(host, bound, 0.05)
    before = kernels.launch_counts()["gather_rows"]
    sc, uc, _ = _dense_sdf(card, bound, 0.05, chunk=20_000)
    assert kernels.launch_counts()["gather_rows"] > before
    assert np.abs(sc - sh).max() < 5e-6 and np.abs(uc - uh).max() < 5e-6
    vh, fh, ch = extract_mesh(host, 0.05)
    vc, fc, cc = extract_mesh(card, 0.05)
    assert len(fh) > 1000
    np.testing.assert_array_equal(fc, fh)
    assert np.abs(vc - vh).max() < 1e-5
    assert np.abs(cc - ch).max() < 1e-5


@pytest.mark.cuda
def test_checkpoint_written_on_card_reads_on_host(mapper_pair, tmp_path):
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.utils import ckpt_io

    host, card = mapper_pair
    card.poses[2] = torch.eye(4, device="cuda") * 2
    card.step = 2
    path = str(tmp_path / "card.pkl")
    card.save_ckpt(path)
    back = Mapper(host.cfg, device="cpu")
    back.load_ckpt(path)
    assert back.step == 2
    for (k, a), (_, b) in zip(ckpt_io.flatten_with_keys(back._ckpt_tree()),
                              ckpt_io.flatten_with_keys(card._ckpt_tree())):
        assert torch.equal(a.detach(), b.detach().cpu()), k
    pts = np.random.default_rng(0).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(back.predict_sdf(pts),
                                  host.predict_sdf(pts))


@pytest.mark.cuda
def test_aggregation_on_card_matches_host(cuda_device):
    """The planner's goal-space aggregation on the card against the same
    on the host, at office0's volume and goal space: the top-k in the same
    order through a run of ties (more zeros than the rest of the top-k),
    the same targets, pairs and validity, the goal scores within 1e-6; and
    the card's own subset draw gives distinct indices into the top-k."""
    from naruto_tpu_torch.planner.aggregation import (Aggregator,
                                                      make_goal_space)

    rng = np.random.default_rng(7)
    shape = (49, 56, 35)
    sdf = rng.uniform(-0.5, 3.0, shape).astype(np.float32)
    uncert = np.where(rng.uniform(size=shape) < 0.02,
                      rng.uniform(0.01, 2.0, shape), 0.0).astype(np.float32)
    gs = make_goal_space(shape, 0.1)
    outs = []
    for dev in ("cpu", cuda_device):
        agg = Aggregator(shape, gs, 0.1, goal_chunk=2048, device=dev)
        sel = torch.from_numpy(rng.permutation(agg.k_eff)[:agg.subset_eff]
                               if dev == "cpu" else outs[0][1])
        out = agg(torch.from_numpy(uncert).to(dev),
                  torch.from_numpy(sdf).to(dev), sel)
        outs.append(([t.cpu() for t in out], sel.numpy()))
    (host, _), (card, _) = outs
    assert np.count_nonzero(uncert) < 4000
    for name, h, c in zip(("gs_aggre", "topk_vxl", "collections",
                           "any_valid"), host, card):
        if name == "gs_aggre":
            torch.testing.assert_close(c, h, rtol=1e-6, atol=0)
        else:
            assert torch.equal(c, h), name
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    vals = torch.from_numpy(np.sort(uncert.reshape(-1))[::-1][:4000]
                            .copy()).to(cuda_device)
    for weighted in (True, False):
        agg.subset_nonzero_weighted = weighted
        sel = agg.draw_subset(vals, gen).cpu()
        assert sel.numel() == 300 == torch.unique(sel).numel()
        assert 0 <= int(sel.min()) and int(sel.max()) < 4000


# ---------------------------------- the vertex layout, weights carry, d_x
@pytest.mark.cuda
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("m,size", [(1, 300), (2049, 4000), (5000, 300),
                                    (1_000_003, 814_897)])
def test_sorted_segment_sum_two_columns_on_card(gen, cuda_device,
                                                round_bf16, m, size):
    """F = 2, the vertex backward's width (its one-column-a-thread path):
    ragged M, empty slots, and the parity grid's 814,897 slots; against
    index_add_ within SEGMENT_TOL, and two calls bit for bit."""
    keys = gen.integers(0, size, m)
    keys[-1] = size - 1
    si = torch.tensor(np.sort(keys), dtype=torch.int32, device=cuda_device)
    vals = torch.tensor(gen.normal(size=(m, 2)), dtype=torch.float32,
                        device=cuda_device)
    got = primitives.sorted_segment_sum(si, vals, size,
                                        round_bf16=round_bf16)
    ref = primitives.sorted_segment_sum_plain(si, vals, size,
                                              round_bf16=round_bf16)
    torch.cuda.synchronize()
    assert _rel(got, ref) <= primitives.SEGMENT_TOL
    assert torch.equal(got, primitives.sorted_segment_sum(
        si, vals, size, round_bf16=round_bf16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 2049, 1_000_003])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_rows_two_f32_columns_on_card(gen, cuda_device, m, idx_dtype):
    """8-byte rows: the vertex table [814,897, 2] f32, bit-exact."""
    tbl = torch.tensor(gen.normal(size=(814_897, 2)), dtype=torch.float32,
                       device=cuda_device)
    idx = torch.tensor(gen.integers(0, 814_897, m), dtype=idx_dtype,
                       device=cuda_device)
    assert torch.equal(primitives.gather_rows(tbl, idx),
                       primitives.gather_rows_plain(tbl, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,per,kb", [(333, 4, 16, 4), (2000, 4, 4000, 8),
                                        (1025, 2, 40, 2)])
def test_weights_carry_on_card_matches_host(gen, cuda_device, n, L, per, kb):
    """The weights carry's segment sum through the kernels on the card and
    the plain versions on the host: identical sort and bf16 factors, f32
    sums in another order, so 2e-6 of max|cumsum|."""
    idx = (gen.integers(0, per, (n, L))
           + np.arange(L)[None, :] * per).astype(np.int32)
    w = gen.uniform(0, 1, (n, L, 8)).astype(np.float32)
    b = gen.normal(size=(n, L * kb)).astype(np.float32)
    args = (torch.tensor(idx), torch.tensor(w), torch.tensor(b))
    ref = segment.dense_segment_sum_outer_level_major(*args, L * per)
    n0 = kernels.launch_counts()["outer_scan_slots"]
    got = segment.dense_segment_sum_outer_level_major(
        *(a.to(cuda_device) for a in args), L * per).cpu()
    assert kernels.launch_counts()["outer_scan_slots"] == n0 + 1
    scale = float(torch.cumsum(ref, 0).abs().max())
    assert float((got - ref).abs().max()) < 2e-6 * scale


def _encode_case(gen, layout, n):
    from naruto_tpu_torch.ops import encoding

    spec = encoding.HashGridSpec(n_levels=4, n_features=2,
                                 log2_table_size=12, base_resolution=8,
                                 finest_resolution=120, layout=layout,
                                 gather_dtype="float32")
    table = encoding.init_hash_table(spec, torch.Generator().manual_seed(0))
    table = {"hash": table["hash"] * 1e3,
             "dense": [d * 1e3 for d in table["dense"]]} \
        if isinstance(table, dict) else table * 1e3
    x = torch.tensor(gen.uniform(0, 1, (n, 3)), dtype=torch.float32)
    g = torch.tensor(gen.normal(size=(n, spec.output_dim)),
                     dtype=torch.float32)
    return encoding, spec, table, x, g


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vertex", "hybrid", "cell"])
@pytest.mark.parametrize("n", [1, 3001])
def test_encode_grads_on_card_match_host(gen, cuda_device, layout, n):
    """hash_encode's table and position gradients through the kernels on
    the card and the plain versions on the host, on the same inputs: d_x
    (a gather of f32 rows, then the same f32 products) within rel 1e-5;
    the table's (bf16-rounded terms summed in another order) within 2e-6
    of max|cumsum|."""
    encoding, spec, table, x, g = _encode_case(gen, layout, n)
    out = []
    for dev in ("cpu", cuda_device):
        tbl = {"hash": table["hash"].to(dev).requires_grad_(True),
               "dense": [d.to(dev).requires_grad_(True)
                         for d in table["dense"]]} \
            if isinstance(table, dict) else table.to(dev).requires_grad_(True)
        xx = x.to(dev).requires_grad_(True)
        leaves = encoding.table_leaves(tbl)
        grads = torch.autograd.grad(encoding.hash_encode(tbl, xx, spec),
                                    [xx, *leaves], g.to(dev))
        out.append([t.cpu() for t in grads])
    (dx_h, *dt_h), (dx_c, *dt_c) = out
    assert _rel(dx_c, dx_h) <= 1e-5
    for got, ref in zip(dt_c, dt_h):
        scale = float(torch.cumsum(ref.reshape(-1, ref.shape[-1]), 0)
                      .abs().max())
        assert float((got - ref).abs().max()) <= 2e-6 * scale


# ------------------------------------------- mesh scenes, snapshots, volumes
@pytest.mark.cuda
def test_raycast_frames_land_on_card_with_host_values(cuda_device):
    """The raycast simulator renders on the host; its frames reach the card
    with the host's values: simulate's float frames, and frame()'s colour
    quantized on the host before the copy, equal to quantize_color of the
    float colour on the card."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.sim.base import quantize_color
    from naruto_tpu_torch.sim.raycast import RaycastSimulator

    cfg = make_config("Replica", "office0", overrides={
        "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
                "cy": 11.5},
        "sim": {"method": "raycast", "pinhole_hw": (24, 32),
                "erp_hw": (16, 32)}})
    rng = np.random.default_rng(0)
    verts = rng.uniform(-3, 3, (900, 3)).astype(np.float32)
    faces = rng.integers(0, 900, (300, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (900, 3)).astype(np.float32)
    sim = RaycastSimulator(cfg, cuda_device, verts=verts, faces=faces,
                           colors=colors)
    c2w = np.eye(4, dtype=np.float32)
    host = sim.render_host(c2w, return_erp=True)
    card = sim.simulate(c2w, return_erp=True)
    assert (host[1] > 0).any()
    for h, c in zip(host, card):
        assert c.is_cuda
        np.testing.assert_array_equal(c.cpu().numpy(), h)
    color, depth = sim.frame(c2w)
    assert color.is_cuda and color.dtype == torch.uint8
    assert torch.equal(color, quantize_color(card[0]))
    assert torch.equal(depth, card[1])


@pytest.mark.cuda
def test_card_generator_states_round_trip_through_a_snapshot(cuda_device,
                                                             tmp_path):
    """The card's Philox generators (seed and offset) ride the snapshot's
    header: a mapper restored from it draws what the writer draws next."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import Mapper

    cfg = make_config("Replica", "office0", num_iter=10, overrides=MESH_TINY)
    a = Mapper(cfg, device=cuda_device)
    for g in a.gens.values():
        assert g.device.type == "cuda"
        torch.rand(7, device=cuda_device, generator=g)
    path = str(tmp_path / "s.pkl")
    a.save_full_state(path)
    b = Mapper(cfg, device=cuda_device)
    b.load_full_state(path)
    for k in a.gens:
        want = torch.rand(5, device=cuda_device, generator=a.gens[k])
        got = torch.rand(5, device=cuda_device, generator=b.gens[k])
        assert torch.equal(got, want), k


@pytest.mark.cuda
def test_lazy_volumes_on_card_match_an_eager_pull(mapper_pair):
    """LazyVolumes' side-stream copy into pinned memory gives the eager
    pull's values bit for bit, once per volume."""
    from naruto_tpu_torch.utils.timer import Timer

    _, card = mapper_pair
    card.timer = Timer()
    vols = card.get_map_volumes_lazy()
    eager = [v.cpu().numpy() for v in card.map_volumes()]
    assert vols.ready() is vols
    for i in (1, 0, 1):
        np.testing.assert_array_equal(vols.host(i), eager[i])
    assert len(card.timer.timings["volumes_wait"]) == 2


# ------------------------------------------------------ images (host code)
@pytest.mark.cuda
def test_codec_builds_and_round_trips_on_card_machine(cuda_device):
    """The codec's library builds where the card is (no cv2 there): PNG
    round trips exact, a JPEG round trip close, jet equal to matplotlib's
    values at its ends and middle."""
    from naruto_tpu_torch.utils import image_io
    from naruto_tpu_torch.visualization import raster

    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:68, 0:120]
    rgb = np.stack([x * 2, y * 3, (x + y) % 256], -1).astype(np.uint8)
    d16 = rng.integers(0, 65536, (68, 120), dtype=np.uint16)
    np.testing.assert_array_equal(
        image_io.decode_png(image_io.encode_png(rgb)), rgb)
    np.testing.assert_array_equal(
        image_io.decode_png(image_io.encode_png(d16)), d16)
    back = image_io.decode_jpeg(image_io.encode_jpeg(rgb))
    assert np.abs(back.astype(int) - rgb).mean() < 2.0
    assert tuple(raster.JET_LUT[0]) == (0.0, 0.0, 0.5)
    assert tuple(raster.JET_LUT[255]) == (0.5, 0.0, 0.0)
    assert tuple(raster.JET_LUT[128]) == (0.4901960784313725, 1.0,
                                          0.4775458570524984)


@pytest.mark.cuda
def test_replayed_frame_on_device(cuda_device, tmp_path):
    """A capture of the analytic room rendered on the card replays as
    tensors on the card, equal to the host replay of the same files."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.config.schema import deep_update
    from naruto_tpu_torch.sim import init_simulator
    from naruto_tpu_torch.sim.scripted import run_scripted_simulation

    cfg = make_config("Replica", "office0", overrides={
        "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
                "cy": 11.5},
        "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32)}})
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = cfg.mapper.bound_np.mean(axis=1)
    run_scripted_simulation(init_simulator(cfg, "cuda"), [c2w, c2w],
                            str(tmp_path))
    rep = deep_update(cfg, {"sim": {"method": "replay",
                                    "scene_path": str(tmp_path)}})
    card, host = init_simulator(rep, "cuda"), init_simulator(rep, "cpu")
    for sim in (card, host):
        sim.update_step(1)
    (cc, cd), (hc, hd) = card.frame(c2w), host.frame(c2w)
    assert cc.is_cuda and cd.is_cuda and cc.dtype == torch.uint8
    assert torch.equal(cc.cpu(), hc) and torch.equal(cd.cpu(), hd)


@pytest.mark.cuda
def test_device_trace_on_cuda(cuda_device, tmp_path):
    """device_trace records the card's kernels into the Chrome trace."""
    import json

    from naruto_tpu_torch.utils import profiling

    x = torch.randn(256, 256, device=cuda_device)
    with profiling.device_trace(str(tmp_path)):
        (x @ x).sum()
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


@pytest.mark.cuda
def test_prefetched_frames_on_card(cuda_device):
    """The frame prefetcher over a raycast scene for 20 steps, each copy
    held back on its stream by a sleep: the frames it delivers equal
    sim.frame's bit for bit (so the consumer's stream waited for each
    copy); a copy is pending on the prefetcher's stream while the
    consumer's stream is idle (another stream); and a pinned buffer is
    rewritten only after the event of its last copy."""
    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.sim.prefetch import FramePrefetcher
    from naruto_tpu_torch.sim.raycast import RaycastSimulator

    cfg = make_config("Replica", "office0", overrides={
        "cam": {"H": 120, "W": 160, "fx": 80.0, "fy": 80.0, "cx": 79.5,
                "cy": 59.5},
        "sim": {"method": "raycast", "pinhole_hw": (120, 160),
                "erp_hw": (16, 32)}})
    rng = np.random.default_rng(0)
    verts = rng.uniform(-3, 3, (900, 3)).astype(np.float32)
    faces = rng.integers(0, 900, (300, 3)).astype(np.int32)
    colors = rng.uniform(0, 1, (900, 3)).astype(np.float32)
    sim = RaycastSimulator(cfg, cuda_device, verts=verts, faces=faces,
                           colors=colors)
    traj = []
    for k in range(20):
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [0.05 * k, -0.03 * k, 0.02 * k]
        traj.append(c2w)
    reused_after_event = []

    class HeldBack(FramePrefetcher):
        def _fill(self, slot, arrays):
            done = self._copied[slot]
            reused_after_event.append(done is None or done.query())
            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(50_000_000)
            return super()._fill(slot, arrays)

    pf = HeldBack(sim, lambda s: traj[s], needs_fn=lambda i: True,
                  horizon=len(traj))
    consumer = torch.cuda.current_stream(cuda_device)
    assert pf._stream != consumer
    got, pending_elsewhere = [], []
    for i in range(len(traj)):
        color, depth = pf.get(i)
        got.append((color.clone(), depth.clone()))   # read on the consumer
        consumer.synchronize()
        if i + 1 < len(traj):
            pf._next.result()        # the next copy is issued, held back
            pending_elsewhere.append(not pf._stream.query()
                                     and consumer.query())
    pf.close()
    assert all(pending_elsewhere) and len(pending_elsewhere) == 19
    assert reused_after_event == [True] * 20
    for c2w, (color, depth) in zip(traj, got):
        want = sim.frame(c2w)
        assert color.is_cuda and color.dtype == torch.uint8
        assert torch.equal(color, want[0]) and torch.equal(depth, want[1])
    assert any(float(d.max()) > 0 for _, d in got)


# ------------------------------------------------ the BA as a CUDA graph
GRAPH_BOUND = ((-2.0, 2.0), (-2.0, 2.0), (-2.0, 2.0))
# the tiny 24x32 mapper of tests/test_torch_ba_graph.py: four BA
# iterations, the uncertainty grid stepping at the second and fourth
GRAPH_TINY = {"cam": {"H": 24, "W": 32, "fx": 20.0, "fy": 20.0, "cx": 15.5,
                      "cy": 11.5, "far": 5.0},
              "grid": {"n_levels": 4, "hash_size": 12, "voxel_sdf": 0.1},
              "mapper": {"sample": 64, "iters": 4, "first_iters": 3,
                         "min_pixels_cur": 4,
                         "act_ray_num_uncert_sample": 8,
                         "uncert_accum_iters": 2, "bound": GRAPH_BOUND,
                         "marching_cubes_bound": GRAPH_BOUND,
                         "voxel_size": 0.5},
              "training": {"n_samples_d": 8, "n_range_d": 5,
                           "smooth_pts": 4}}
GRAPH_SETTINGS = {
    "hybrid": {},
    "vertex": {"grid": {"layout": "vertex", "n_levels": 16,
                        "n_features_per_level": 2,
                        "table_dtype": "float32"}},
    "weights_carry": {"grid": {"sort_carry": "weights"}},
    "importance": {"training": {"n_importance": 4}},
    "smooth_sample": {"training": {"smooth_sample": 64}},
    "pose": {"mapper": {"tracking_enable": True, "pose_accum_step": 2}},
}
# buckets of the calls held form against form: a bucket change and back,
# each bucket's first call (warm-up, capture) and replays
GRAPH_CALLS = (512, 512, 2048, 512, 2048)


def _graph_cfg(name):
    from naruto_tpu_torch.config import make_config

    over = {k: {**v, **GRAPH_SETTINGS[name].get(k, {})}
            for k, v in GRAPH_TINY.items()}
    return make_config("Replica", "office0", num_iter=40, overrides=over)


def _graph_frame(seed):
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (24, 32)).astype(np.float32)
    depth[:3] = 0.0
    return rng.uniform(0, 1, (24, 32, 3)).astype(np.float32), depth


def _graph_pose(i):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.02 * i, -0.01 * i, 0.0]
    return c2w


def _graph_mapper(cfg, dev):
    """A card mapper after its first frame, three keyframes and a volume
    query."""
    from naruto_tpu_torch.mapping.mapper import Mapper

    m = Mapper(cfg, device=dev)
    m.update_step(0)
    m.online_recon_step(0, *_graph_frame(0), _graph_pose(0))
    for s in (5, 10):
        m.poses[s] = torch.from_numpy(_graph_pose(s)).to(dev)
        m.add_keyframe(m.frame_to_rays(*_graph_frame(s)), s)
    m.map_volumes()
    return m


def _graph_state(m) -> dict:
    from naruto_tpu_torch.utils import ckpt_io
    from naruto_tpu_torch.utils.seeding import generator_states

    torch.cuda.synchronize()
    out = {k: ckpt_io._to_numpy(x)
           for k, x in ckpt_io.flatten_with_keys(m._full_state_tree())}
    out.update({f"generator {k}": v
                for k, v in generator_states(m.gens).items()})
    return out


def _assert_graph_equal(got_aux, want_aux, got_m, want_m, what):
    assert [list(a) for a in got_aux] == [list(a) for a in want_aux], what
    for a, b in zip(got_aux, want_aux):
        for k in a:
            assert torch.equal(a[k], b[k]), (what, k)
    got, want = _graph_state(got_m), _graph_state(want_m)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


def _graph_call(m, eager: bool, bucket: int, k: int):
    fid = 15 + k
    fr = m.frame_to_rays(*_graph_frame(fid))
    c2w = torch.from_numpy(_graph_pose(fid)).to(m.device)
    call = m._ba_impl_eager if eager else m._ba_impl
    return call(bucket, fr, c2w, fid)


def _replays(bucket: int) -> int:
    from naruto_tpu_torch.mapping import ba_graph

    return ba_graph.graph_counts().get(bucket, {}).get("replays", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(GRAPH_SETTINGS))
def test_ba_graph_equals_eager_on_card(cuda_device, name):
    """Mapper._ba_impl on the card replays one captured graph per bucket,
    and every call of GRAPH_CALLS (the first, which warms every bucket up,
    each bucket's first, which captures, and the others, across bucket
    changes) equals the eager loop's call from the same state bit for bit:
    every state leaf, the generators, the poses written back and every
    loss. Every call is one replay, counted by bucket with the captures and
    the warm-ups."""
    from naruto_tpu_torch.mapping import ba_graph
    from naruto_tpu_torch.mapping.mapper import CUR_BUCKETS

    cfg = _graph_cfg(name)
    graph = _graph_mapper(cfg, cuda_device)
    eager = _graph_mapper(cfg, cuda_device)
    graphs = graph._ba_graphs
    assert graphs is not None and eager._ba_graphs is not None
    ba_graph.reset_graph_counts()
    for k, bucket in enumerate(GRAPH_CALLS):
        got = _graph_call(graph, False, bucket, k)
        want = _graph_call(eager, True, bucket, k)
        _assert_graph_equal(got, want, graph, eager, f"call {k}")
    assert sorted(graphs.programs) == sorted(CUR_BUCKETS)
    assert sorted(b for b, p in graphs.programs.items()
                  if p.graph is not None) == [512, 2048]
    assert ba_graph.graph_counts() == {
        b: {"calls": GRAPH_CALLS.count(b), "replays": GRAPH_CALLS.count(b),
            "captures": int(b in GRAPH_CALLS), "warm_ups": 1}
        for b in CUR_BUCKETS}


@pytest.mark.cuda
def test_ba_graph_capture_outlives_dead_graphs(cuda_device):
    """A dead CUDA graph in a reference cycle (as a dropped mapper leaves
    its graphs) that turns to garbage while a BA call is captured is not
    collected inside the capture, whose graph it would invalidate: the
    capture holds off the cyclic collector, and the call equals the eager
    one."""
    import gc

    cfg = _graph_cfg("hybrid")
    graph = _graph_mapper(cfg, cuda_device)
    eager = _graph_mapper(cfg, cuda_device)
    x = torch.zeros(4, device=cuda_device)
    dead = [torch.cuda.CUDAGraph()]
    with torch.cuda.graph(dead[0]):
        x += 1
    iteration = graph._ba_iteration
    thresholds = gc.get_threshold()

    def dropping(setup, draws, it):
        if kernels.is_capturing() and dead:
            cycle = [dead.pop()]
            cycle.append(cycle)
            del cycle
            gc.set_threshold(1)     # the next allocations would collect it
        return iteration(setup, draws, it)

    graph._ba_iteration = dropping
    try:
        got = _graph_call(graph, False, 512, 0)   # warm-up, capture, replay
    finally:
        gc.set_threshold(*thresholds)
    assert not dead and graph._ba_graphs.programs[512].graph is not None
    want = _graph_call(eager, True, 512, 0)
    _assert_graph_equal(got, want, graph, eager, "call 0")


@pytest.mark.cuda
def test_ba_graph_replays_after_load_full_state(cuda_device, tmp_path):
    """A replay after load_full_state reads the loaded state (the load
    writes into the addresses the graph holds): it equals an eager call on
    another mapper loaded from the same snapshot."""
    from naruto_tpu_torch.mapping.mapper import Mapper

    cfg = _graph_cfg("pose")
    graph = _graph_mapper(cfg, cuda_device)
    for k in range(2):
        _graph_call(graph, False, 512, k)      # captured, then replayed
    src = _graph_mapper(cfg, cuda_device)
    _graph_call(src, True, 2048, 7)
    path = str(tmp_path / "state.pkl")
    src.save_full_state(path)
    eager = Mapper(cfg, device=cuda_device)
    graph.load_full_state(path)
    eager.load_full_state(path)
    replays = _replays(512)
    for k in (3, 4):
        got = _graph_call(graph, False, 512, k)
        want = _graph_call(eager, True, 512, k)
        _assert_graph_equal(got, want, graph, eager, f"call {k}")
    assert _replays(512) == replays + 2


@pytest.mark.cuda
def test_ba_graph_launch_accounting(cuda_device):
    """The warm-up's iterations launch what the eager call's do, a capture
    launches nothing it counts, and each replay adds the launches its
    capture recorded, per iteration, which are the eager call's; one graph
    launch a call."""
    from naruto_tpu_torch.mapping.mapper import CUR_BUCKETS
    from naruto_tpu_torch.ops import kernels

    cfg = _graph_cfg("hybrid")
    iters = cfg.mapper.iters
    graph = _graph_mapper(cfg, cuda_device)
    eager = _graph_mapper(cfg, cuda_device)
    kernels.reset_launch_counts()
    _graph_call(eager, True, 512, 0)
    torch.cuda.synchronize()
    eager_counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    replays = _replays(512)
    _graph_call(graph, False, 512, 0)      # warm-up, capture, one replay
    assert kernels.launch_counts() == {
        k: n * (len(CUR_BUCKETS) + 1) for k, n in eager_counts.items()}
    assert _replays(512) == replays + 1
    prog = graph._ba_graphs.programs[512]
    # the decoders' Adam every iteration, the uncertainty grid's at its
    # steps (no pose optimisation here)
    uncert, pose = graph._ba_steps()
    assert uncert and not pose
    assert prog.launches_per_iter == [
        {"outer_scan_slots": 1, "outer_scan_rows": 0, "gather_rows": 3,
         "row_cumsum": 0, "sorted_segment_sum": 1, "embed_adam": 1,
         "adam": 1 + (it in uncert), "query_inputs": 0,
         "trilerp_forward": 1, "trilerp_vjp": 1}
        for it in range(iters)]
    assert eager_counts == {
        k: sum(c[k] for c in prog.launches_per_iter) for k in eager_counts}
    for k in (1, 2):
        kernels.reset_launch_counts()
        replays = _replays(512)
        _graph_call(graph, False, 512, k)
        assert _replays(512) == replays + 1
        assert kernels.launch_counts() == eager_counts


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["hybrid", "pose"])
def test_ba_graph_stage_events(cuda_device, name):
    """A bucket's graph records 1 + 4 x iters timing events: the call's
    start, then the end of each iteration's sample, forward, backward and
    step. After a replay the four stages' sums, with the call's head (to
    the start mark) and tail (from the last mark), equal the time between
    events recorded around the replay within 5%; the store keeps the marks
    of the program replayed last, and the eager call records none."""
    from naruto_tpu_torch.utils.timer import SPANS

    cfg = _graph_cfg(name)
    iters = cfg.mapper.iters
    m = _graph_mapper(cfg, cuda_device)
    SPANS.replayed = None
    _graph_call(m, True, 512, 0)
    assert SPANS.replayed is None and SPANS.stage_ms() is None
    _graph_call(m, False, 512, 1)          # warm-up, capture, one replay
    prog = m._ba_graphs.programs[512]
    assert [n for n, _ in prog.stages] == ["start"] + [
        "sample", "forward", "backward", "step"] * iters
    assert SPANS.replayed is prog.stages
    for _ in range(3):
        before = torch.cuda.Event(enable_timing=True)
        after = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        before.record()
        prog.replay()
        after.record()
        ms = SPANS.stage_ms()
        assert sorted(ms) == ["backward", "forward", "sample", "step"]
        assert all(v > 0 for v in ms.values()), ms
        head = before.elapsed_time(prog.stages[0][1])
        tail = prog.stages[-1][1].elapsed_time(after)
        whole = before.elapsed_time(after)
        assert head >= 0 and tail >= 0
        assert abs(sum(ms.values()) + head + tail - whole) <= 0.05 * whole


@pytest.mark.cuda
def test_ba_graph_failed_capture_raises(cuda_device):
    """A capture that fails raises, and the bucket's later calls raise too,
    without running the call eagerly: the state and the generators stay as
    they were."""
    from naruto_tpu_torch.ops import kernels

    m = _graph_mapper(_graph_cfg("hybrid"), cuda_device)
    before = _graph_state(m)
    replays = _replays(512)
    batch = m._ba_batch

    def refuses_capture(setup, draws):
        if kernels.is_capturing():
            raise RuntimeError("refused inside the capture")
        return batch(setup, draws)

    m._ba_batch = refuses_capture
    with pytest.raises(RuntimeError, match="refused inside the capture"):
        _graph_call(m, False, 512, 0)
    with pytest.raises(RuntimeError, match="failed to capture"):
        _graph_call(m, False, 512, 1)
    after = _graph_state(m)
    # the calls wrote their poses into the table; nothing else moved
    after["['poses']"][15:17] = before["['poses']"][15:17]
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert _replays(512) == replays


# ---------------------------------------------------- the optimizer steps
def _card_scalars(values, dev) -> torch.Tensor:
    """Host float64 scalars as the float32 device tensor a call's row
    holds."""
    return torch.tensor(values, dtype=torch.float64).to(torch.float32).to(dev)


# (shapes, lr, weight decay) of the mapper's Adam groups at office0: the
# decoders' four leaves, the uncertainty grid, each pose group (keyframe
# slots and the current frame)
ADAM_GROUPS = {
    "decoder": ([[(80, 32), (32, 16), (63, 32), (32, 3)]], [1e-2], 1e-6),
    "uncert": ([[(49, 56, 35)]], [1.0], 0.0),
    "pose": ([[(100, 3), (3,)], [(100, 3), (3,)]], [1e-3, 1e-3], 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ADAM_GROUPS))
def test_adam_equals_torch_adam_on_card(cuda_device, name):
    """The mapper's Adam (csrc/adam.cu's adam, one launch an optimizer step)
    with device-scalar corrections equals torch.optim.Adam's update on the
    card (its multi-tensor form, whose addcdiv fuses the product and the
    sum) bit for bit over 50 steps, parameters and both moments: the
    decoders (weight decay 1e-6, four leaves), the uncertainty grid and
    the pose's two groups (opt_rot, opt_trans)."""
    from naruto_tpu_torch.mapping.optim import Adam

    groups, lrs, wd = ADAM_GROUPS[name]
    rng = np.random.default_rng(5)
    shapes = [s for g in groups for s in g]
    init = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(cuda_device) for s in shapes]
    ref = [p.clone().requires_grad_(True) for p in init]
    got = [p.clone() for p in init]
    spans, lo = [], 0
    for g in groups:
        spans.append((lo, lo + len(g)))
        lo += len(g)
    torch_adam = torch.optim.Adam(
        [{"params": ref[a:b], "lr": lr} for (a, b), lr in zip(spans, lrs)],
        betas=(0.9, 0.99), eps=1e-8, weight_decay=wd)
    ours = [Adam(got[a:b], lr, (0.9, 0.99), 1e-8, wd)
            for (a, b), lr in zip(spans, lrs)]
    for count in range(1, 51):
        grads = [torch.from_numpy((rng.standard_normal(s) * 10.0
                                   ** rng.uniform(-6, 1)).astype(np.float32))
                 .to(cuda_device) for s in shapes]
        for p, g in zip(ref, grads):
            p.grad = g.clone()
        torch_adam.step()
        for opt, (a, b) in zip(ours, spans):
            scal = _card_scalars(opt.scalars(count), cuda_device)
            n0 = kernels.launch_counts()["adam"]
            opt.step(grads[a:b], scal[0], scal[1])
            assert kernels.launch_counts()["adam"] == n0 + 1
        for a, b in zip(got, ref):
            assert torch.equal(a, b.detach()), count
        for opt, (a, _) in zip(ours, spans):
            for j in range(len(opt.params)):
                st = torch_adam.state[ref[a + j]]
                assert torch.equal(opt.exp_avg[j], st["exp_avg"]), count
                assert torch.equal(opt.exp_avg_sq[j], st["exp_avg_sq"]), \
                    count


# the hybrid table's three leaves (hash rows, the two dense grids) and the
# parity table, in one launch, with a ragged leaf (numel % 4 = 1), one of
# zero gradients and a misaligned one (a view one float into its buffer)
EMBED_SHAPES = [(131_072, 64), (17, 17, 17, 8), (42, 42, 42, 8),
                (814_897, 2), (1001,), (333, 3)]
ZERO_GRAD_LEAF, MISALIGNED_LEAF = 4, 5


def _embed_leaves(dev, gen):
    leaves = []
    for i, s in enumerate(EMBED_SHAPES):
        n = int(np.prod(s))
        buf = torch.empty(n + 1, device=dev)
        x = buf[1:] if i == MISALIGNED_LEAF else buf[:n]
        leaves.append(x.view(s).uniform_(-1e-4, 1e-4, generator=gen))
    assert leaves[MISALIGNED_LEAF].data_ptr() % 16
    return leaves


def _embed_grads(dev, gen):
    """Gradients whose magnitudes spread from 1e-30 to 1e3 (log-uniform,
    so the squares underflow to subnormals and to zero), a tenth of them
    zero, one leaf all zero."""
    grads = []
    for i, s in enumerate(EMBED_SHAPES):
        mag = 10.0 ** torch.empty(s, device=dev).uniform_(-30, 3,
                                                          generator=gen)
        g = torch.randn(s, device=dev, generator=gen) * mag
        g *= torch.rand(s, device=dev, generator=gen) > 0.1
        grads.append(g.zero_() if i == ZERO_GRAD_LEAF else g)
    return grads


@pytest.mark.cuda
def test_embed_adam_equals_plain_chain_on_card(cuda_device):
    """The table's Adam (csrc/adam.cu's embed_adam) equals its plain chain
    on the card bit for bit over 25 steps with device-scalar corrections:
    parameters and both moments, at the hybrid table's three leaves and
    the parity table's [814,897, 2] in one launch a step, beside a ragged,
    an all-zero-gradient and a misaligned leaf."""
    from naruto_tpu_torch.mapping.optim import EmbedAdam

    gen = torch.Generator(device=cuda_device).manual_seed(7)
    got = _embed_leaves(cuda_device, gen)
    ref = [p.clone() for p in got]
    opt, plain = EmbedAdam(got, 1e-2), EmbedAdam(ref, 1e-2)
    for count in range(1, 26):
        grads = _embed_grads(cuda_device, gen)
        scal = _card_scalars(EmbedAdam.scalars(count), cuda_device)
        n0 = kernels.launch_counts()["embed_adam"]
        opt.step(got, grads, scal[0], scal[1])
        assert kernels.launch_counts()["embed_adam"] == n0 + 1
        plain.step_plain(ref, grads, scal[0], scal[1])
        for a, b in zip(got + opt.mu + opt.nu, ref + plain.mu + plain.nu):
            assert torch.equal(a, b), count
    assert all(bool(torch.isfinite(p).all()) for p in got)


@pytest.mark.cuda
def test_optimizer_graph_replays_read_the_scalars(cuda_device):
    """An optimizer step captured in a CUDA graph reads its corrections
    when it runs: replays after writing the scalars of other step counts
    each equal an eager step with those counts, bit for bit, for both
    kernels; the capture counts its launch in its own tally."""
    from naruto_tpu_torch.mapping.optim import Adam, EmbedAdam

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    table = _embed_leaves(cuda_device, gen)
    tgrads = _embed_grads(cuda_device, gen)
    shapes = ADAM_GROUPS["decoder"][0][0]
    dec = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
    dgrads = [torch.randn_like(p) for p in dec]
    t_ref, d_ref = [p.clone() for p in table], [p.clone() for p in dec]
    embed, embed_ref = EmbedAdam(table, 1e-2), EmbedAdam(t_ref, 1e-2)
    adam = Adam(dec, 1e-2, (0.9, 0.99), 1e-8, 1e-6)
    adam_ref = Adam(d_ref, 1e-2, (0.9, 0.99), 1e-8, 1e-6)
    scal = torch.zeros(4, device=cuda_device)

    def step():
        embed.step(table, tgrads, scal[0], scal[1])
        adam.step(dgrads, scal[2], scal[3])

    # both kernels run once before the capture (their module loaded)
    spare = [torch.zeros(4, device=cuda_device)]
    EmbedAdam(spare, 1e-2).step(spare, spare, scal[0], scal[1])
    Adam(spare, 1e-2, (0.9, 0.99), 1e-8).step(spare, scal[2], scal[3])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    with kernels.capturing() as tally, torch.cuda.graph(graph):
        step()
    assert kernels.launch_counts() == before
    assert tally["embed_adam"] == 1 and tally["adam"] == 1
    for count in (1, 7, 2):
        scal.copy_(_card_scalars(EmbedAdam.scalars(count)
                                 + adam.scalars(count), cuda_device))
        graph.replay()
        row = _card_scalars(EmbedAdam.scalars(count) + adam.scalars(count),
                            cuda_device)
        embed_ref.step(t_ref, tgrads, row[0], row[1])
        adam_ref.step(dgrads, row[2], row[3])
        torch.cuda.synchronize()
        for a, b in zip(table + embed.mu + embed.nu + dec + adam.exp_avg
                        + adam.exp_avg_sq,
                        t_ref + embed_ref.mu + embed_ref.nu + d_ref
                        + adam_ref.exp_avg + adam_ref.exp_avg_sq):
            assert torch.equal(a, b), count


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["non_contiguous", "float64", "shape",
                                   "scalar_dtype"])
def test_optimizer_step_refuses_bad_leaves_on_card(cuda_device, fault):
    """The card's optimizer step raises, before any launch, on a leaf that
    is not contiguous, not float32 or not of its parameter's shape, and on
    corrections that are not float32 device scalars."""
    from naruto_tpu_torch.mapping.optim import EmbedAdam

    params = [torch.zeros((6, 8), device=cuda_device),
              torch.zeros((5,), device=cuda_device)]
    grads = [torch.ones_like(p) for p in params]
    scal = _card_scalars(EmbedAdam.scalars(1), cuda_device)
    if fault == "non_contiguous":
        grads[0] = torch.ones((8, 6), device=cuda_device).t()
    elif fault == "float64":
        grads[1] = grads[1].double()
    elif fault == "shape":
        grads[0] = grads[0].reshape(8, 6)
    else:
        scal = scal.double()
    opt = EmbedAdam(params, 1e-2)
    n0 = kernels.launch_counts()["embed_adam"]
    with pytest.raises(ValueError):
        opt.step(params, grads, scal[0], scal[1])
    assert kernels.launch_counts()["embed_adam"] == n0


# ------------------------------------- the vertex grid's SDF decoder input
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["office0 grid", "jiraiya chunk",
                                  "random points"])
def test_query_inputs_equal_the_chain_on_card(cuda_device, case):
    """csrc/query_inputs.cu's [n, 80] equals the encode and one-blob chain
    on the same card tensors bit for bit, in one launch: office0's 96,040
    voxels, the first 2^20-voxel chunk of jiraiya's 306^3 grid, and 4,913
    random points, a tenth with a coordinate on a face (0 or 1)."""
    from naruto_tpu_torch.scripts import probe_query_inputs as probe

    if case == "office0 grid":
        spec, x = probe.scene("Replica", "office0")
    else:
        spec, x = probe.scene("NARUTO", "jiraiya")
        x = (x[:probe.CHUNK].contiguous() if case == "jiraiya chunk"
             else probe.random_points(4913, 7))
    table = probe.random_table(spec.hash_spec, 5)
    assert probe.compare(case, table, x, spec.hash_spec, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("levels,bins", [(2, 8), (4, 4)])
def test_query_inputs_small_grids_on_card(cuda_device, levels, bins):
    """Grids of 2 and 4 levels with 8 and 4 bins (rows of 28 and 20
    columns: other strides and stores than the vertex grid's 80) equal the
    chain bit for bit."""
    from naruto_tpu_torch.ops.encoding import HashGridSpec
    from naruto_tpu_torch.scripts import probe_query_inputs as probe

    spec = HashGridSpec(n_levels=levels, log2_table_size=12,
                        finest_resolution=200)
    assert probe.compare(f"L{levels}F2, {bins} bins",
                         probe.random_table(spec, 8),
                         probe.random_points(3001, 9), spec, bins)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["office0", "jiraiya"])
def test_query_inputs_volumes_equal_the_chain_on_card(cuda_device, scene,
                                                      monkeypatch):
    """The chunked map query through the kernel gives the chain's SDF and
    uncertainty volumes bit for bit (the decoder's GEMM reads the same
    bits at the same shape): office0's 96,040 voxels in one chunk, and
    jiraiya's first 1,500,000 voxels in a chunk of 2^20 and a short one."""
    from naruto_tpu_torch.mapping import field
    from naruto_tpu_torch.ops import encoding
    from naruto_tpu_torch.scripts import probe_query_inputs as probe

    spec, x = probe.scene(*(("Replica", "office0") if scene == "office0"
                            else ("NARUTO", "jiraiya")))
    x = x[:1_500_000].contiguous()
    params = field.init_field_params(
        spec, torch.Generator(device="cuda").manual_seed(3), "cuda")
    params["table"].normal_(generator=torch.Generator(
        device="cuda").manual_seed(4))
    params["uncert_grid"].normal_(generator=torch.Generator(
        device="cuda").manual_seed(5))
    for p in encoding.table_leaves(params["table"]):
        p.requires_grad_(True)
    field.reset_volume_counts()
    n0 = kernels.launch_counts()["query_inputs"]
    with torch.no_grad():
        got = field.chunked_volume_maps(params, x, spec)
    assert kernels.launch_counts()["query_inputs"] - n0 == \
        field.volume_counts()["chunks"] == (1 if scene == "office0" else 2)
    monkeypatch.setattr(field, "query_inputs_refusal",
                        lambda *a: "the chain, for this test")
    with torch.no_grad():
        want = field.chunked_volume_maps(params, x, spec)
    assert kernels.launch_counts()["query_inputs"] - n0 == \
        (1 if scene == "office0" else 2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int((got[1] > 0).sum()) < got[1].numel()


def _jiraiya_tiny_cfg():
    """jiraiya's bound, 0.02 m volumes (306^3) and vertex grid, on the
    graph tests' 24x32 frames and BA settings."""
    from naruto_tpu_torch.config import make_config

    mapper = {k: v for k, v in GRAPH_TINY["mapper"].items()
              if k not in ("bound", "marching_cubes_bound", "voxel_size")}
    return make_config("NARUTO", "jiraiya", num_iter=40, overrides={
        "cam": GRAPH_TINY["cam"], "grid": GRAPH_SETTINGS["vertex"]["grid"],
        "mapper": mapper, "training": GRAPH_TINY["training"]})


@pytest.mark.cuda
def test_query_inputs_launch_once_a_chunk_on_card(cuda_device):
    """At jiraiya's volumes on the vertex grid a map query launches the
    kernel once a chunk (28 of 2^20 voxels); a BA call, eager or a graph
    replay, never (its forward asks the table's gradient); the hybrid
    grid's query never."""
    from naruto_tpu_torch.mapping import field

    m = _graph_mapper(_jiraiya_tiny_cfg(), cuda_device)
    assert m.grid01.shape[0] == 306 ** 3
    kernels.reset_launch_counts()
    field.reset_volume_counts()
    m.map_volumes()
    torch.cuda.synchronize()
    assert field.volume_counts()["chunks"] == -(-306 ** 3 // field.VOLUME_CHUNK)
    assert kernels.launch_counts()["query_inputs"] == \
        field.volume_counts()["chunks"]
    kernels.reset_launch_counts()
    _graph_call(m, True, 512, 0)
    _graph_call(m, False, 512, 1)
    _graph_call(m, False, 512, 2)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["query_inputs"] == 0 and counts["embed_adam"] > 0
    hybrid = _graph_mapper(_graph_cfg("hybrid"), cuda_device)
    kernels.reset_launch_counts()
    hybrid.map_volumes()
    assert kernels.launch_counts()["query_inputs"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["table_grad", "points_grad", "hybrid",
                                   "bfloat16"])
def test_query_inputs_refuse_on_card(cuda_device, fault):
    """The wrapper raises, before any launch, where a gradient is asked or
    the grid is not the vertex layout with float32 gathers."""
    import dataclasses

    from naruto_tpu_torch.ops import encoding
    from naruto_tpu_torch.scripts import probe_query_inputs as probe

    spec = encoding.HashGridSpec(n_levels=4, n_features=2,
                                 log2_table_size=12, finest_resolution=64)
    table = probe.random_table(spec, 1)
    x = probe.random_points(100, 2)
    if fault == "table_grad":
        table.requires_grad_(True)
    elif fault == "points_grad":
        x.requires_grad_(True)
    else:
        spec = dataclasses.replace(
            spec, **({"layout": "hybrid"} if fault == "hybrid"
                     else {"gather_dtype": "bfloat16"}))
        table = encoding.init_hash_table(spec, torch.Generator(
            device="cuda").manual_seed(0), "cuda")
    n0 = kernels.launch_counts()["query_inputs"]
    with pytest.raises(ValueError):
        encoding.vertex_query_inputs(table, x, spec, 16)
    assert kernels.launch_counts()["query_inputs"] == n0


# ------------ the trilinear sample in a graph and in a jiraiya BA call
# (after the profiler tests: once a process has captured a graph, the
# tracer loses most records)
@pytest.mark.cuda
def test_trilerp_in_a_captured_graph_on_card(cuda_device):
    """The sample and the grid gradient captured in one CUDA graph at
    jiraiya's grid: each of two replays, on new grid values and samples
    written into the captured inputs, equals the plain versions bit for
    bit; the capture counts one launch of each kernel in its own tally."""
    from naruto_tpu_torch.ops import grid_sample as gs

    shape = TRILERP_GRIDS["jiraiya"]
    vol, coords, g = _trilerp_inputs(shape, "rays", 12)

    def step():
        key, w, _, vals = gs.trilerp_forward(vol, coords)
        return (torch.sum(vals * w, dim=-1),
                gs._vol_grad(shape, key, g[:, None] * w))

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):      # the segment sum's state, made
        step()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counts()
    with kernels.capturing() as tally, torch.cuda.graph(graph, stream=stream):
        out = step()
    assert kernels.launch_counts() == before
    assert tally["trilerp_forward"] == tally["trilerp_vjp"] == 1
    assert tally["sorted_segment_sum"] == 1 and tally["gather_rows"] == 0
    for seed in (13, 14):
        for dst, src in zip((vol, coords, g),
                            _trilerp_inputs(shape, "rays", seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, _trilerp_plain(vol, coords, g)):
            assert torch.equal(a, b), seed


def _jiraiya_ba_cfg():
    """_jiraiya_tiny_cfg with jiraiya's own BA batch: 2,048 keyframe rays
    and its samples a ray (93,568 samples an iteration at the 512
    bucket)."""
    from naruto_tpu_torch.config import make_config

    mapper = {k: v for k, v in GRAPH_TINY["mapper"].items()
              if k not in ("bound", "marching_cubes_bound", "voxel_size",
                           "sample")}
    return make_config("NARUTO", "jiraiya", num_iter=40, overrides={
        "cam": GRAPH_TINY["cam"], "grid": GRAPH_SETTINGS["vertex"]["grid"],
        "mapper": mapper})


@pytest.mark.cuda
def test_jiraiya_ba_call_equals_the_dense_pack_path_on_card(
        cuda_device, tmp_path, monkeypatch):
    """At jiraiya's 306^3 uncertainty grid, a map query of all its voxels
    (28 chunks) and an eager BA call from the same state equal, bit for
    bit, those run on the dense-pack path (tests/dense_trilerp.py swapped
    in for the sample): both volumes, every loss and every state leaf."""
    from dense_trilerp import dense_trilerp

    from naruto_tpu_torch.mapping import field
    from naruto_tpu_torch.mapping.mapper import Mapper
    from naruto_tpu_torch.ops import grid_sample

    cfg = _jiraiya_ba_cfg()
    src = _graph_mapper(cfg, cuda_device)
    path = str(tmp_path / "state.pkl")
    src.save_full_state(path)
    del src
    runs = []
    for trilerp in (grid_sample._trilerp, dense_trilerp):
        monkeypatch.setattr(grid_sample, "_trilerp", trilerp)
        m = Mapper(cfg, device=cuda_device)
        m.load_full_state(path)
        with torch.no_grad():
            vols = field.chunked_volume_maps(m.params, m.grid01, m.spec)
        kernels.reset_launch_counts()
        aux = _graph_call(m, True, 512, 3)
        torch.cuda.synchronize()
        runs.append((m, vols, aux, kernels.launch_counts()))
    (new, new_vols, new_aux, counts), (old, old_vols, old_aux, _) = runs
    for a, b in zip(new_vols, old_vols):
        assert torch.equal(a, b)
    _assert_graph_equal(new_aux, old_aux, new, old, "jiraiya BA call")
    iters = cfg.mapper.iters
    assert counts["trilerp_forward"] == counts["trilerp_vjp"] == iters
    assert counts["gather_rows"] == iters
