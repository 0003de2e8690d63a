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
from naruto_tpu.ops.grid_sample import trilinear_sample as j_trilinear
from naruto_tpu_torch.ops import kernels, primitives, segment
from naruto_tpu_torch.ops.grid_sample import trilinear_sample
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


# ------------------------------------------------------- dense_segment_sum
# Layouts of keys that stress a segment sum over runs: (name, rows, size)
SEGMENT_LAYOUTS = [
    ("uniform", 4000, 50),
    ("one_dominant_key", 4000, 300),     # > 50% of the rows in one key
    ("empty_ends", 3000, 900),           # first key > 0, last key < size - 1
    ("size_beyond_keys", 2500, 5000),    # size > max key + 1, long gaps
]


def _segment_keys(rng, name, n, size):
    if name == "uniform":
        return rng.integers(0, size, n)
    if name == "one_dominant_key":
        return np.concatenate([rng.integers(0, size, n - (n * 3) // 5),
                               np.full((n * 3) // 5, size // 3)])
    if name == "empty_ends":
        return rng.integers(size // 3, size // 2, n)
    return np.concatenate([rng.integers(0, 5, n // 2),
                           rng.integers(2000, 2010, n - n // 2)])


@pytest.mark.parametrize("name,n,size", SEGMENT_LAYOUTS)
@pytest.mark.parametrize("kwargs", [{}, {"pack_bf16": False}],
                         ids=["default", "pack_bf16_false"])
def test_dense_segment_sum_matches_jax(rng, kwargs, name, n, size):
    """The port's dense_segment_sum has JAX's signature and default: with
    pack_bf16 (the default) each value is rounded to bf16 before the f32
    sums. Same values either way. The port sums each run directly; JAX
    differences an f32 prefix sum over all rows (and its sort is not
    stable), so its slot sums carry the running total's rounding: 1e-6 of
    max|cumsum|, the scale of that prefix sum."""
    idx = _segment_keys(rng, name, n, size).astype(np.int32)
    rng.shuffle(idx)
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    ref = np.asarray(jseg.dense_segment_sum(jnp.asarray(idx),
                                            jnp.asarray(vals), size, **kwargs))
    got = segment.dense_segment_sum(torch.tensor(idx), torch.tensor(vals),
                                    size, **kwargs).numpy()
    assert got.shape == ref.shape == (size, 8)
    assert not got[np.setdiff1d(np.arange(size), idx)].any()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("name,n,size", SEGMENT_LAYOUTS)
@pytest.mark.parametrize("pack_bf16", [True, False])
def test_dense_segment_sum_two_columns_matches_jax(rng, pack_bf16, name, n,
                                                   size):
    """F = 2, the vertex layout's width (its backward passes pack_bf16, the
    default: the JAX function then sorts one bf16 pair per row), against
    the JAX function: the port's one sort and one segment sum fed the
    permutation. Tolerance as at F = 8: 1e-6 of max|cumsum|."""
    idx = _segment_keys(rng, name, n, size).astype(np.int32)
    rng.shuffle(idx)
    vals = rng.normal(size=(n, 2)).astype(np.float32)
    ref = np.asarray(jseg.dense_segment_sum(jnp.asarray(idx),
                                            jnp.asarray(vals), size,
                                            pack_bf16=pack_bf16))
    got = segment.dense_segment_sum(torch.tensor(idx), torch.tensor(vals),
                                    size, pack_bf16=pack_bf16).numpy()
    assert got.shape == ref.shape == (size, 2)
    assert not got[np.setdiff1d(np.arange(size), idx)].any()
    scale = np.abs(np.cumsum(ref, axis=0)).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * scale)


def test_dense_segment_sum_is_one_sort_and_one_segment_sum(rng):
    """No gather of the values: the segment sum is fed the sort
    permutation and the values as they are."""
    idx = torch.tensor(rng.integers(0, 40, 300), dtype=torch.int64)
    vals = torch.tensor(rng.normal(size=(300, 2)), dtype=torch.float32)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        for name in ("gather_rows", "sorted_segment_sum"):
            fn = getattr(primitives, name)
            mp.setattr(primitives, name,
                       lambda *a, _f=fn, _n=name, **k:
                       (calls.append((_n, a, k)), _f(*a, **k))[1])
        segment.dense_segment_sum(idx, vals, 40)
    assert [c[0] for c in calls] == ["sorted_segment_sum"]
    (_, (si, v, size), kw), = calls
    assert v is vals and size == 40
    assert torch.equal(si, torch.sort(idx.int(), stable=True).values)
    assert torch.equal(kw["perm"], torch.sort(idx.int(), stable=True).indices)


@pytest.mark.parametrize("crowded", [False, True])
def test_trilinear_vjp_through_segment_sum_matches_jax(rng, crowded):
    """The uncertainty grid's volume gradient (sort, sorted_segment_sum fed
    the permutation, then the corner transpose) against the JAX
    package's VJP on the same inputs, with the points spread over the grid
    or, as the BA's rays do, crowded into a few cells (long runs, most
    cells empty). f32 on both sides, per-cell sums in another order: 1e-6
    of max|d_vol|."""
    vol = rng.normal(size=(9, 10, 7)).astype(np.float32)
    pts = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    if crowded:
        pts = (0.4 + 0.15 * pts).astype(np.float32)
        pts[:1800] = 0.47 + 0.01 * pts[:1800]
    g = rng.normal(size=(3000,)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: j_trilinear(v, jnp.asarray(pts)),
                     jnp.asarray(vol))
    ref, = vjp(jnp.asarray(g))
    tv = torch.tensor(vol, requires_grad=True)
    got, = torch.autograd.grad(trilinear_sample(tv, torch.tensor(pts)), tv,
                               torch.tensor(g))
    assert _rel_err(got.numpy(), np.asarray(ref, np.float64)) < 1e-6


# ----------------------------------- the segment-sum kernel's tiling, modelled
INT32_MAX = 2 ** 31 - 1
# (name, rows, size) for a tile of 4 stretches x 4 rows = 16 rows: a key over
# many tiles, a late first key, an early last key, long gaps, keys outside
# [0, size), and M one more / one less than a multiple of the tile
WRITE_RULE_LAYOUTS = [
    ("uniform", 160, 40),
    ("uniform", 161, 40),
    ("uniform", 159, 40),
    ("uniform", 7, 40),
    ("one_dominant_key", 200, 30),
    ("one_dominant_key", 193, 30),
    ("single_key", 64, 9),
    ("first_key_late", 100, 90),
    ("last_key_early", 100, 90),
    ("long_gaps", 130, 5000),
    ("out_of_range", 120, 50),
    ("all_negative", 40, 12),
    ("last_key_int32_max", 50, 20),
    ("no_rows", 0, 12),
]


def _write_rule_keys(rng, name, n, size):
    if name == "uniform":
        keys = rng.integers(0, size, n)
    elif name == "one_dominant_key":
        keys = np.concatenate([rng.integers(0, size, n - (n * 3) // 5),
                               np.full((n * 3) // 5, size // 2)])
    elif name == "single_key":
        keys = np.full(n, 4)
    elif name == "first_key_late":
        keys = rng.integers(size // 2, size, n)
    elif name == "last_key_early":
        keys = rng.integers(0, size // 3, n)
    elif name == "long_gaps":
        keys = np.concatenate([rng.integers(0, 5, n // 3),
                               rng.integers(2500, 2510, n // 3),
                               rng.integers(size - 3, size, n - 2 * (n // 3))])
    elif name == "out_of_range":
        keys = np.concatenate([rng.integers(-30, 0, n // 4),
                               rng.integers(0, size, n // 2),
                               rng.integers(size, size + 40, n - n // 4
                                            - n // 2)])
    elif name == "all_negative":
        keys = rng.integers(-9, 0, n)
    elif name == "last_key_int32_max":
        keys = np.concatenate([rng.integers(0, size, n - 20),
                               np.full(20, INT32_MAX)])
    else:
        keys = np.zeros(0)
    return np.sort(keys).astype(np.int32)


class _Slots:
    """The output as the kernel's stores see it: counts the writes of each
    slot and refuses a store outside [0, size)."""

    def __init__(self, size, nf):
        self.out = np.full((size, nf), np.nan, np.float32)
        self.writes = np.zeros(size, np.int64)
        self.size = size

    def emit(self, a, end, total):
        """The write rule of a closing row: its run's sum to out[a] if a is
        a slot, zeros to the slots strictly between a and `end`."""
        if 0 <= a < self.size:
            self.out[a] = total
            self.writes[a] += 1
        self.zero(0 if a < 0 else a + 1, end)

    def zero(self, lo, end):
        if end > lo:
            assert 0 <= lo and end <= self.size
            self.out[lo:end] = 0.0
            self.writes[lo:end] += 1


def _scan_stretches(xs, fl):
    """Segmented inclusive Hillis-Steele scan over the stretches, in place:
    fl marks a stretch that closes a run, after which the sum starts anew."""
    d = 1
    while d < len(fl):
        pv, pf = xs.copy(), fl.copy()
        for g in range(d, len(fl)):
            if not fl[g]:
                xs[g] = xs[g] + pv[g - d]
            fl[g] = fl[g] or pf[g - d]
        d *= 2


def _tiled_model(si, vals, size, ngr=4, L=4, perm=None, P=2):
    """csrc/sorted_segment_sum.cu in numpy, step by step. A tile has ngr
    stretches of L rows. Runs inside a stretch are written at once; a
    segmented scan over the stretches (flag: the stretch closes a run;
    value: its sum after the last closing row) joins the rest; every tile
    publishes one record. The run open at a tile's first row takes the
    records of the tiles before that it covers, which are found from the
    keys alone. f32 adds throughout. With perm, each tile stages its rows
    from their places: its slice of perm read in chunks of P indices (the
    last chunk of the last tile short), row r copied from vals[perm[r]].
    Returns the slots and the records each tile read."""
    m = si.shape[0]
    nf = vals.shape[1]
    if perm is not None:
        staged = np.full((m, nf), np.nan, np.float32)
        R = ngr * L
        for t in range(max(1, -(-m // R))):
            r_hi = min(R, m - t * R)
            for q in range(-(-r_hi // P)):
                chunk = perm[t * R + q * P:t * R + min(q * P + P, r_hi)]
                assert len(chunk) == P or q == r_hi // P
                for k, s in enumerate(chunk):
                    assert 0 <= s < vals.shape[0]
                    staged[t * R + q * P + k] = vals[s]
        assert not np.isnan(staged).any()      # every row staged
        vals = staged
    R = ngr * L
    ntiles = max(1, -(-m // R))
    slots = _Slots(size, nf)
    recs = np.zeros((ntiles, nf), np.float32)
    owners = []
    zero = np.zeros(nf, np.float32)
    # the slots before the first key of all and after the last: shared out
    # among the tiles
    lead = min(max(int(si[0]), 0), size) if m else size
    trail = min(max(int(si[-1]) + 1, 0), size) if m else size
    empty = lead + size - trail
    share = -(-empty // ntiles)
    for t in range(ntiles):
        for i in range(t * share, min((t + 1) * share, empty)):
            u = i if i < lead else trail + i - lead
            slots.zero(u, u + 1)
        s0 = t * R
        xs = np.zeros((ngr, nf), np.float32)
        fl = np.zeros(ngr, bool)
        heads = [None] * ngr
        for g in range(ngr):
            acc, closes = zero, False
            for i in range(s0 + g * L, min(s0 + g * L + L, m)):
                acc = acc + vals[i]
                last = i == m - 1
                if last or si[i] != si[i + 1]:
                    # the slots after the last key are not this row's
                    end = 0 if last else min(int(si[i + 1]), size)
                    if not closes:
                        heads[g] = (int(si[i]), end, acc)
                    else:
                        slots.emit(int(si[i]), end, acc)
                    acc, closes = zero, True
            xs[g], fl[g] = acc, closes
        _scan_stretches(xs, fl)
        recs[t] = xs[ngr - 1]
        for g in range(ngr):
            if heads[g] is None:
                continue
            key, end, head = heads[g]
            before = xs[g - 1] if g else zero
            if g and fl[g - 1]:
                slots.emit(key, end, head + before)
            else:
                owners.append((t, key, end, head, before))
    reads = {}
    for t, key, end, head, before in owners:
        carry = zero
        if t > 0 and si[t * R - 1] == si[t * R]:
            assert key == si[t * R]
            nrec = 1
            if si[(t - 1) * R] == key:
                inside = next((e for e in range(t)
                               if si[(t - 1 - e) * R] != key), t)
                nrec = inside + (inside < t
                                 and si[(t - inside) * R - 1] == key)
            reads[t] = nrec
            for e in range(nrec):
                carry = carry + recs[t - 1 - e]
        slots.emit(key, end, head + (before + carry))
    return slots, reads


@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("name,n,size", WRITE_RULE_LAYOUTS)
def test_segment_kernel_tiling_model(rng, name, n, size, round_bf16):
    """The kernel's tiling and write rule, modelled in numpy on tiles of
    16 and of 20 rows, on the narrow rows' tiles of 16 and 32 rows (more
    stretches a tile), and with rows staged by a permutation, against
    sorted_segment_sum's plain version: every slot is written exactly once
    (so the output needs no memset), empty slots and gaps hold 0, keys
    outside [0, size) are dropped, a run over many tiles reads one record
    per tile it covers, and the permuted staging reads every row once.
    Small integer values, so every sum is exact in any order and the
    comparison is bit for bit."""
    si = _write_rule_keys(rng, name, n, size)
    vals = rng.integers(-8, 9, (n, 3)).astype(np.float32) \
        * (1.0 if round_bf16 else 0.125)
    keep = (si >= 0) & (si < size)
    ref = primitives.sorted_segment_sum(
        torch.tensor(si[keep]), torch.tensor(vals[keep]), size,
        round_bf16=round_bf16).numpy()
    # the values as the sort left them: unsorted rows (and more of them
    # than keys) that the permutation points into
    perm = rng.permutation(n + 7)[:n]
    unsorted = np.zeros((n + 7, 3), np.float32)
    unsorted[perm] = vals
    # wide rows (4 stretches of 4 or 5 of 4), narrow rows (one thread a
    # row: more stretches a tile, 8 of 2 or of 4), and both fed the
    # permutation in int64 (P = 2) or int32 (P = 4) chunks
    tilings = ({}, {"ngr": 5}, {"ngr": 8, "L": 2}, {"ngr": 8, "L": 4},
               {"perm": perm}, {"ngr": 8, "L": 2, "perm": perm},
               {"ngr": 5, "perm": perm, "P": 4},
               {"ngr": 8, "L": 4, "perm": perm, "P": 4})
    for tiling in tilings:
        rows = unsorted if "perm" in tiling else vals
        slots, reads = _tiled_model(si, rows, size, **tiling)
        assert (slots.writes == 1).all()
        np.testing.assert_array_equal(slots.out, ref)
        rows_a_tile = tiling.get("ngr", 4) * tiling.get("L", 4)
        if name in ("one_dominant_key", "single_key") and n > 3 * rows_a_tile:
            assert max(reads.values()) >= 3      # a run over several tiles
    if name == "no_rows":
        assert not slots.out.any()


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


@pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("round_bf16", [True, False])
def test_segment_sum_plain_with_perm_sums_the_gathered_rows(rng, round_bf16,
                                                            perm_dtype):
    """With perm, the plain version is the sum of vals[perm]: bit for bit
    the plain version on the gathered rows (the same index_add_), and
    jax.ops.segment_sum of those rows within 1e-6 of max|ref|. The values
    may have more rows than the keys; the permutation picks M of them."""
    m, size, v_rows = 5000, 3000, 5300
    keys = _sorted_keys(rng, m, size)
    vals = rng.normal(size=(v_rows, 2)).astype(np.float32)
    perm = rng.permutation(v_rows)[:m]
    tv, tp = torch.tensor(vals), torch.tensor(perm, dtype=perm_dtype)
    got = primitives.sorted_segment_sum(torch.tensor(keys), tv, size,
                                        round_bf16=round_bf16, perm=tp)
    gathered = primitives.gather_rows(tv, tp)
    assert torch.equal(got, primitives.sorted_segment_sum(
        torch.tensor(keys), gathered, size, round_bf16=round_bf16))
    jv = jnp.asarray(vals[perm])
    if round_bf16:
        jv = jv.astype(jnp.bfloat16).astype(jnp.float32)
    ref = np.asarray(jax.ops.segment_sum(jv, jnp.asarray(keys),
                                         num_segments=size))
    assert _rel_err(got.numpy(), ref) < 1e-6


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
    perm = torch.arange(10)
    with pytest.raises(TypeError):
        primitives.sorted_segment_sum(ix, vals, 4, round_bf16=True,
                                      perm=perm.short())
    with pytest.raises(ValueError):
        primitives.sorted_segment_sum(ix, vals, 4, round_bf16=True,
                                      perm=perm[:9])
    with pytest.raises(ValueError, match="contiguous"):
        primitives.sorted_segment_sum(ix, vals, 4, round_bf16=True,
                                      perm=torch.arange(20)[::2])
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
        out = primitives.sorted_segment_sum(
            si, v, 64, round_bf16=False, perm=torch.arange(m).flip(0))
        assert out.shape == (64, 8) and float(out.sum()) == 8 * m
        assert primitives.row_cumsum(v).shape == (m, 8)
    assert kernels.launch_counts() == before
