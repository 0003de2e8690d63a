"""Micro-benchmarks of the hash-grid hot-loop primitives on one NVIDIA card
(counterpart of scripts/microbench_primitives.py).

Run:  python -m naruto_tpu_torch.scripts.microbench_primitives [--quick]

Harness, as in the JAX script: each row is ONE step(state) -> state whose
outputs feed the next call's inputs; two warm calls, then `reps` calls
timed on the host clock with one torch.cuda.synchronize() at the end.

The rows the JAX script ran through XLA (takes, sorts, merge-rank, cumsum,
the one-hot matmul scatter) are plain PyTorch here; the dense_segment_sum
row is the port's (a sort, then gather_rows and sorted_segment_sum). Its
Pallas rows go through the port's hand-written CUDA kernels
(ops/primitives.py): the windowed accumulate (P1) through
sorted_segment_sum on bf16-rounded updates, both VMEM-table takes (P2, P3)
through gather_rows, the triangular-matmul cumsum (P4) through row_cumsum.
Each kernel row is checked against its plain version and fails the run if
it disagrees. Every row covers all M updates (the JAX kernels' M // block
grids leave a ragged tail out).
"""
from __future__ import annotations

import argparse
import time

import torch

from naruto_tpu_torch.ops import primitives
from naruto_tpu_torch.ops.segment import dense_segment_sum

M = 3_000_000        # updates per BA iter (93.6k pts x 4 levels x 8 corners)
T = 201_000          # hash table rows
F = 8                # features per row
TS = 65_536          # rows of one level's table (the gather rows)
T0 = 4913            # rows of the small dense level (one-hot rows)
ONE_HOT_W = 5120     # its one-hot width
PRIME = 2654435761


def tpad(t: int) -> int:
    """Output rows of the windowed-accumulate rows: T rounded up to 128."""
    return ((t + 127) // 128) * 128


def bench(name, step_fn, state, reps=10):
    """Two warm calls, then mean milliseconds of `reps` chained calls."""
    state = step_fn(state)
    state = step_fn(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        state = step_fn(state)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps * 1000
    print(f"{name:55s} {dt:9.2f} ms", flush=True)
    return dt


def remix(ix: torch.Tensor, mod: int) -> torch.Tensor:
    """Cheap index remix to keep inputs fresh: (ix * PRIME) mod 2^32, as
    uint32, mod `mod` (the JAX script's uint32 arithmetic, in int64)."""
    return (((ix.to(torch.int64) * PRIME) & 0xFFFFFFFF) % mod).to(torch.int32)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| / max |ref| (0 for an all-zero exact match)."""
    diff = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    return diff / scale if scale else diff


def make_data(m: int, t: int, nf: int, device, seed: int = 0):
    """idx0 [m] int32 in [0, t), upd0 [m, nf] and table [t, nf] f32 N(0, 1)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    idx0 = torch.randint(0, t, (m,), generator=g, device=device,
                         dtype=torch.int32)
    upd0 = torch.randn((m, nf), generator=g, device=device)
    table = torch.randn((t, nf), generator=g, device=device)
    return idx0, upd0, table


def level_table(table: torch.Tensor, ts: int) -> torch.Tensor:
    """[ts, F] bf16: the first ts // 4 rows tiled 4 times (one level)."""
    return table.to(torch.bfloat16)[: ts // 4].repeat(4, 1)


def pack_bf16_pairs(v: torch.Tensor) -> torch.Tensor:
    """[N, 2k] f32 -> [N, k] int32 of its bf16 values, two to a word."""
    return v.to(torch.bfloat16).view(torch.int32)


# ------------------------------------------------------------ row functions
def take_step(tbl: torch.Tensor):
    """XLA take of rows: index_select; the index remix wraps at tbl's rows."""
    n = tbl.shape[0]

    def step(st):
        ix, acc = st
        out = tbl.index_select(0, ix)
        return remix(ix, n), acc + out[:, :1].float().sum()
    return step


def gather_step(tbl: torch.Tensor):
    """The Pallas VMEM-table takes: the gather_rows kernel."""
    n = tbl.shape[0]

    def step(st):
        ix, acc = st
        out = primitives.gather_rows(tbl, ix)
        return remix(ix, n), acc + out[:1].float().sum()
    return step


def vsort_step(mod: int, copies: int = 1):
    """lax.sort of a key with int32 payload columns (the payload repeated
    `copies` times): a stable key sort, then one row gather of the
    payload."""
    def step(st):
        ix, p = st
        s, perm = torch.sort(ix, stable=True)
        sp = (p.repeat(1, copies) if copies > 1 else p).index_select(0, perm)
        return remix(s, mod), sp[:, :p.shape[1]].contiguous()
    return step


def ksort_step(mod: int):
    """lax.sort of (key, iota): torch.sort's values and positions."""
    def step(st):
        ix, = st
        s, pos = torch.sort(ix, stable=True)
        return (remix(s ^ pos.to(torch.int32), mod),)
    return step


def merge_rank_step(t: int):
    """Run boundaries by merge rank: two argsorts of M + t keys."""
    def step(st):
        si, = st
        m = si.shape[0]
        ar = torch.arange(t, dtype=torch.int32, device=si.device)
        merged = torch.cat([si * 2, ar * 2 + 1])
        rank = torch.argsort(torch.argsort(merged, stable=True), stable=True)
        ub = rank[m:].to(torch.int32) - ar
        return (torch.sort(remix(si ^ ub[:1], t)).values,)
    return step


def cumsum_step(st):
    """XLA cumsum over rows: torch.cumsum along dim 0."""
    v, = st
    c = torch.cumsum(v, dim=0)
    return (v + c[-1:] * 1e-9,)


def row_cumsum_step(st):
    """The Pallas triangular-matmul cumsum: the row_cumsum kernel."""
    v, = st
    c = primitives.row_cumsum(v)
    return (v + c[-1:] * 1e-9,)


def dense_segment_sum_step(t: int):
    """The port's dense_segment_sum: a stable sort, a gather by its
    permutation, and sorted_segment_sum over the runs."""
    def step(st):
        ix, v = st
        out = dense_segment_sum(ix, v, t)
        return remix(ix, t), v + out[:1] * 1e-9
    return step


def segment_step(t: int, *, round_bf16: bool):
    """The Pallas windowed accumulate: the sorted_segment_sum kernel into
    tpad(t) slots, then the next sorted keys."""
    def step(st):
        si, sv = st
        out = primitives.sorted_segment_sum(si, sv, tpad(t),
                                            round_bf16=round_bf16)
        return torch.sort(remix(si, t)).values, sv + out[:1] * 1e-9
    return step


def one_hot(ix: torch.Tensor, width: int, dtype) -> torch.Tensor:
    """[N, width] one-hot rows of ix, made in `dtype` directly."""
    oh = torch.zeros((ix.shape[0], width), dtype=dtype, device=ix.device)
    return oh.scatter_(1, ix[:, None].long(), 1)


def one_hot_step(t0: int, width: int, dtype):
    """One-hot matmul scatter of the updates into `width` slots (t0 used):
    the one-hot matrix materialized in `dtype`, then one torch.matmul (a
    bf16 product returns bf16 in torch; its accumulation is f32)."""
    def step(st):
        ix, v = st
        out = torch.matmul(one_hot(ix, width, dtype).t(), v.to(dtype))
        return remix(ix, t0), v + out[:1].float() * 1e-9
    return step


# --------------------------------------------------------------------- main
def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("microbench_primitives: no CUDA device; it measures "
                         "the card and does not run on the CPU")
    reps = 5 if args.quick else 10
    dev = torch.device("cuda")
    idx0, upd0, table_f32 = make_data(M, T, F, dev)
    torch.cuda.synchronize()
    print(f"device={torch.cuda.get_device_name(0)}  M={M}  T={T}  F={F}")
    zero = torch.zeros((), device=dev)

    # ---------------- 1. takes
    bench("take [T,8] f32 x 3M (index_select)", take_step(table_f32),
          (idx0, zero), reps)
    table_bf16 = table_f32.to(torch.bfloat16)
    bench("take [T,8] bf16 x 3M (index_select)", take_step(table_bf16),
          (idx0, zero), reps)
    tw = table_bf16.repeat(1, 8)[: T // 8].contiguous()
    bench("take [25k,64] bf16 x 375k (index_select)", take_step(tw),
          (idx0[: M // 8] % (T // 8), zero), reps)

    # ---------------- 2. sorts
    packed0 = pack_bf16_pairs(upd0)
    bench("sort 3M (key + 4 int32 payload)", vsort_step(T),
          (idx0, packed0), reps)
    bench("sort 3M (key + iota)", ksort_step(T), (idx0,), reps)
    bench("sort 96k (key + iota)", ksort_step(T), (idx0[:96_000],), reps)

    # ---------------- 3. merge-rank boundaries
    si0 = torch.sort(idx0).values
    bench("merge-rank (2 argsorts of 3.2M)", merge_rank_step(T), (si0,), reps)

    # ---------------- 4. cumsum
    bench("torch.cumsum(v, 0) [3M,8] f32", cumsum_step, (upd0,), reps)

    # ---------------- the port's dense_segment_sum (bf16-rounded values)
    bench("dense_segment_sum (sort + gather + segment sum)",
          dense_segment_sum_step(T), (idx0, upd0), reps)

    # ---------------- 5. P1 -> sorted_segment_sum, bf16-rounded updates
    size = tpad(T)
    bench("P1 sorted_segment_sum bf16 3M -> [TPAD,8] (cuda)",
          segment_step(T, round_bf16=True), (si0, upd0), reps)
    got = primitives.sorted_segment_sum(si0, upd0, size, round_bf16=True)
    exact = primitives.sorted_segment_sum_plain(si0, upd0, size,
                                                round_bf16=False)
    plain = primitives.sorted_segment_sum_plain(si0, upd0, size,
                                                round_bf16=True)
    err = rel_err(got, plain)
    print(f"    max abs err vs segment_sum: "
          f"{float((got - exact).abs().max()):.2e} (bf16-rounded updates); "
          f"vs its plain version {err:.2e} of max|plain|")
    check(err <= primitives.SEGMENT_TOL, f"P1 sorted_segment_sum err {err}")

    # ---------------- 6. P2, P3 -> gather_rows from one level's table
    table_lvl = level_table(table_f32, TS)
    ixs = idx0 % TS
    bench("P2 gather_rows [TS,8] bf16 x 3M (cuda)", gather_step(table_lvl),
          (ixs, zero), reps)
    match = bool(torch.equal(primitives.gather_rows(table_lvl, ixs),
                             primitives.gather_rows_plain(table_lvl, ixs)))
    print("    match:", match)
    check(match, "P2 gather_rows differs from index_select")
    bench("P3 gather_rows [TS,8] bf16 x 3M (cuda)", gather_step(table_lvl),
          (ixs, zero), reps)

    # ---------------- 7. P4 -> row_cumsum
    bench("P4 row_cumsum [3M,8] f32 (cuda)", row_cumsum_step, (upd0,), reps)
    got = primitives.row_cumsum(upd0)
    ref = torch.cumsum(upd0, dim=0)
    rel = float(((ref - got).abs() / (ref.abs() + 1e-3)).max())
    err = rel_err(got, primitives.row_cumsum_plain(upd0))
    print(f"    max rel err: {rel:.2e}; vs its plain version {err:.2e} of "
          f"max|plain|")
    check(err <= primitives.CUMSUM_TOL, f"P4 row_cumsum err {err}")

    # ---------------- 8. one-hot matmul scatter for the small dense level
    bench("one-hot matmul scatter 750k->4913 (bf16)",
          one_hot_step(T0, ONE_HOT_W, torch.bfloat16),
          (idx0[:750_000] % T0, upd0[:750_000]), reps)


if __name__ == "__main__":
    main()
