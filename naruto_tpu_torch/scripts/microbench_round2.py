"""Round-2 micro-benchmarks on one NVIDIA card (counterpart of
scripts/microbench_round2.py): pair-row gathers, in-kernel gather variants,
the exact-f32 windowed accumulate at several block sizes, the f32 one-hot
scatter and variadic sorts at pair scale.

Run:  python -m naruto_tpu_torch.scripts.microbench_round2

The XLA rows are plain PyTorch. The Pallas rows go through the port's CUDA
kernels: the broadcast-index and 1-D takes (P5, P6) through gather_rows,
the windowed accumulate (P7) through sorted_segment_sum in exact f32. The
kernel has no block-size knob, so the JAX script's (BK, WIN) sweep survives
only as the rows' labels: the four rows run the same kernel.
"""
from __future__ import annotations

import argparse

import torch

from naruto_tpu_torch.ops import primitives
from naruto_tpu_torch.scripts.microbench_primitives import (
    F, M, ONE_HOT_W, T, T0, TS, bench, check, gather_step, level_table,
    make_data, one_hot, one_hot_step, pack_bf16_pairs, rel_err, segment_step,
    take_step, tpad, vsort_step)

SEG_SWEEP = ((4096, 1024), (8192, 1024), (8192, 2048), (16384, 2048))


def pair_table(table: torch.Tensor) -> torch.Tensor:
    """[T, 2F]: each row beside the next one (the paired-x layout)."""
    return torch.cat([table, torch.roll(table, -1, dims=0)], dim=1)


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise SystemExit("microbench_round2: no CUDA device; it measures the "
                         "card and does not run on the CPU")
    dev = torch.device("cuda")
    idx0, upd0, table_f32 = make_data(M, T, F, dev)
    torch.cuda.synchronize()
    print(f"device={torch.cuda.get_device_name(0)}")
    zero = torch.zeros((), device=dev)

    # ---- pair-row gathers: 1.5M rows x 16 elems (the paired-x layout)
    mp = M // 2
    pair_f32 = pair_table(table_f32)
    pair_bf16 = pair_f32.to(torch.bfloat16)
    idxp0 = idx0[:mp]
    bench("take pair [T,16] f32 x 1.5M", take_step(pair_f32), (idxp0, zero))
    bench("take pair [T,16] bf16 x 1.5M", take_step(pair_bf16), (idxp0, zero))
    # cell-dup layout: 375k rows x 64 elems
    bench("take cell [T,64] bf16 x 375k", take_step(pair_bf16.repeat(1, 4)),
          (idx0[: M // 8], zero))
    bench("take cell [T,64] f32 x 375k", take_step(pair_f32.repeat(1, 4)),
          (idx0[: M // 8], zero))
    # int32-packed bf16 pairs: [T, 8] int32 rows == 16 bf16
    bench("take pair-as-int32 [T,8]i32 x 1.5M",
          take_step(pair_bf16.view(torch.int32)), (idxp0, zero))

    # ---- the VMEM-table gathers: P5 (broadcast indices), P6 (one column)
    table_lvl = level_table(table_f32, TS)
    ixs = idx0 % TS
    bench("P5 gather_rows [TS,8] bf16 x 3M (cuda)", gather_step(table_lvl),
          (ixs, zero))
    match = bool(torch.equal(primitives.gather_rows(table_lvl, ixs),
                             primitives.gather_rows_plain(table_lvl, ixs)))
    print("    match:", match)
    check(match, "P5 gather_rows differs from index_select")
    tcol = table_lvl[:, :1].contiguous()
    bench("P6 gather_rows [TS,1] bf16 column x 3M (cuda)", gather_step(tcol),
          (ixs, zero))
    match = bool(torch.equal(primitives.gather_rows(tcol, ixs),
                             primitives.gather_rows_plain(tcol, ixs)))
    print("    match:", match)
    check(match, "P6 gather_rows differs from index_select")

    # ---- P7: the exact-f32 windowed accumulate, the sweep as labels
    size = tpad(T)
    sidx0 = torch.sort(idx0).values
    for bk, win in SEG_SWEEP:
        bench(f"P7 sorted_segment_sum f32 [BK={bk} WIN={win}] (cuda)",
              segment_step(T, round_bf16=False), (sidx0, upd0))
        got = primitives.sorted_segment_sum(sidx0, upd0, size,
                                            round_bf16=False)
        ref = primitives.sorted_segment_sum_plain(sidx0, upd0, size,
                                                  round_bf16=False)
        err = rel_err(got, ref)
        print(f"    max abs err: {float((got - ref).abs().max()):.2e} "
              f"({err:.2e} of max|segment_sum|)")
        check(err <= primitives.SEGMENT_TOL, f"P7 sorted_segment_sum {err}")

    # ---- one-hot matmul scatter, small T, exact f32
    ix, v = idx0[:750_000] % T0, upd0[:750_000]
    bench("one-hot f32 matmul scatter 750k->4913",
          one_hot_step(T0, ONE_HOT_W, torch.float32), (ix, v))
    ref = primitives.sorted_segment_sum_plain(ix, v, ONE_HOT_W,
                                              round_bf16=False)
    got = torch.matmul(one_hot(ix, ONE_HOT_W, torch.float32).t(), v)
    print(f"    max abs err: {float((ref - got).abs().max()):.2e}")

    # ---- variadic sorts at pair scale
    packedp = pack_bf16_pairs(upd0[:mp])
    bench("sort 1.5M (key + 4 int32 payload)", vsort_step(T),
          (idxp0, packedp))
    bench("sort 1.5M (key + 8 int32 payload)", vsort_step(T, copies=2),
          (idxp0, packedp))


if __name__ == "__main__":
    main()
