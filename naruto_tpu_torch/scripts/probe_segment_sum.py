"""Probe what bounds the segment-sum kernel (csrc/sorted_segment_sum.cu) on
one NVIDIA card: the tree's kernel against variants of its source, in turns,
at the microbenchmarks' shape ([3,000,000, 8] into 201,088 slots, uniform
keys), with one key holding 60% of those rows, and at the BA's shape
([93,568, 8] into 89,760 slots).

Run:  python -m naruto_tpu_torch.scripts.probe_segment_sum [--reps N]

A variant is the tree's source with text substitutions: another tile size
(stretches of at most 4, 8 or 16 rows), or a part of the work removed (its
name says which). Each is built with the flags of ops/kernels.py into
naruto_tpu_torch/_build/probe/ (ptxas's report is printed), called through
the same entry point on the same inputs, and timed by the profiler's device
time (the mean over --reps calls), in turns: every variant in order, then in
reverse order. A variant that skips work gives wrong results: its output is
timed, never used. Variants that keep the arithmetic are compared with the
plain version. Beside them: a device-to-device copy of the values (what
the card takes to read and write 96 MB) and the plain index_add_.
"""
from __future__ import annotations

import argparse

import torch

from naruto_tpu_torch.ops import kernels, primitives
from naruto_tpu_torch.scripts.probe_outer_scan import _build
from naruto_tpu_torch.scripts.trace_summary import device_ms

_SRC = kernels._CSRC / "sorted_segment_sum.cu"
_MAX_LSH = "constexpr int MAX_LSH = 4;"
_PUT = "    store_row<W>(out + slot * nf + col0 + j * W, v);\n"
_TICKET = "const lookback::Ticket tk = lookback::take_ticket(state);"
_SHARE = ("const unsigned share = (empty + (unsigned)ntiles - 1) / "
          "(unsigned)ntiles;")
_SMALL = "constexpr int SMALL_GAP = 32;"
# "timeline": thread 0 of each block stamps the global timer at eight points
# into the look-back state, from int32 word `at` on, past the words the
# kernel uses
STAMPS = ("entered", "ticket", "staged", "walked", "scanned", "published",
          "joined", "stored")


def _timeline(at: int) -> list:
    return [
        ('#include "lookback.cuh"\n',
         '#include "lookback.cuh"\n'
         "__device__ __forceinline__ unsigned long long now() {\n"
         "  unsigned long long ts;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ts));\n'
         "  return ts;\n}\n"
         "__device__ __forceinline__ void stamp(unsigned* s, int64_t t,\n"
         "                                      int k,\n"
         "                                      unsigned long long ts) {\n"
         "  if (threadIdx.x) return;\n"
         f"  reinterpret_cast<unsigned long long*>(s + {at})[t * 8 + k] ="
         " ts;\n}\n"),
        ("  " + _TICKET + "\n  const int64_t t = tk.tile;\n",
         "  const unsigned long long t_in = now();\n  " + _TICKET
         + "\n  const int64_t t = tk.tile;\n  stamp(state, t, 0, t_in);\n"
         "  stamp(state, t, 1, now());\n"),
        ("  const int key0 = keys[0];",
         "  stamp(state, t, 2, now());\n  const int key0 = keys[0];"),
        ("  // Segmented scan over the stretches, in a fixed order.",
         "  stamp(state, t, 3, now());\n"
         "  // Segmented scan over the stretches, in a fixed order."),
        ("  // The tile's record, published before any wait",
         "  stamp(state, t, 4, now());\n"
         "  // The tile's record, published before any wait"),
        ("  // column c of tile u's record, once it is there",
         "  stamp(state, t, 5, now());\n"
         "  // column c of tile u's record, once it is there"),
        ("  if (active && closes && open) {",
         "  stamp(state, t, 6, now());\n  if (active && closes && open) {"),
        ("  if (tid == 0) lookback::finish(",
         "  stamp(state, t, 7, now());\n  if (tid == 0) lookback::finish("),
    ]


# name -> (substitutions, whether the output stays right); the timeline's
# substitutions are made once the state's size is known
VARIANTS = {
    "timeline": (None, True),
    "tree": ([], True),
    "tile id from blockIdx": (
        [(_TICKET, "const lookback::Ticket tk = {(int64_t)blockIdx.x, "
          "*(volatile unsigned*)(state + 2) + 1u};")], True),
    "first tile zeroes lead and trail": (
        [(_SHARE, "const unsigned share = t == 0 ? empty : 0;")], True),
    "gaps up to 8 slots by their rows": (
        [(_SMALL, "constexpr int SMALL_GAP = 8;")], True),
    "every gap by its row's threads": (
        [(_SMALL, "constexpr int SMALL_GAP = 0x7fffffff;")], True),
    "stretches <= 8 rows": ([(_MAX_LSH, "constexpr int MAX_LSH = 3;")], True),
    "stretches of 4 rows": ([(_MAX_LSH, "constexpr int MAX_LSH = 2;")], True),
    "no stores": ([(_PUT, "    if (v[0] == 1.2345e-30f) out[slot] = v[0];\n")],
                  False),
}
# name -> (rows, slots, share of the rows in one key; or, negative, the
# number of neighbouring slots in the middle that hold every key; or,
# negative and under 100, the spacing of the slots that hold keys)
SHAPES = {
    "uniform 3M": (3_000_000, 201_088, 0.0),
    "one key 60% 3M": (3_000_000, 201_088, 0.6),
    "BA 93,568": (93_568, 89_760, 0.0),
    "BA 93,568 in 25,000 cells": (93_568, 89_760, -25_000),
    "BA 93,568 in every 3.5th cell": (93_568, 89_760, -3.5),
    "BA 93,568 in every 20th cell": (93_568, 89_760, -20.0),
}
F = 8


def _print_timeline(state, at: int, call, shape: str, m: int) -> None:
    """One call of the timeline variant: when each block reached each
    stamp, in us from the first block's entry (quantiles over blocks), and
    how long each phase took."""
    state[at:].zero_()
    call()
    torch.cuda.synchronize()
    ts = state[at:].view(torch.int64).view(-1, 8)[:, :len(STAMPS)]
    ts = ts[ts[:, 0] > 0].double().cpu()
    ts = (ts - ts[:, 0].min()) / 1e3
    q = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], dtype=torch.float64)
    print(f"{shape} timeline: {ts.shape[0]} tiles of {m} rows")
    for k, name in enumerate(STAMPS):
        print(f"{shape} timeline {name:9s} at us (min/p10/p50/p90/max): "
              + " / ".join(f"{v:.2f}" for v in torch.quantile(ts[:, k], q)))
    for k in range(1, len(STAMPS)):
        d = ts[:, k] - ts[:, k - 1]
        print(f"{shape} timeline {STAMPS[k - 1]} -> {STAMPS[k]} us "
              f"(min/p10/p50/p90/max): "
              + " / ".join(f"{v:.2f}" for v in torch.quantile(d, q)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment_sum: no CUDA device; it measures the "
                         "card and does not run on the CPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tree = _SRC.read_text()
    # one look-back state for every library, as big as the wrapper makes it
    # for the largest shape, and room for the timeline's stamps after it
    m_max = max(m for m, _, _ in SHAPES.values())
    state0, cap = kernels.scan_state(torch.zeros(1, device=dev).device,
                                     m_max // 32 + 2, 2 * F)
    at = state0.numel() + state0.numel() % 2
    state = torch.zeros(at + 16 * (m_max // 32 + 1), dtype=torch.int32,
                        device=dev)
    libs = {}
    for name, (subs, exact) in VARIANTS.items():
        code = tree
        for old, new in subs if subs is not None else _timeline(at):
            if old not in code:
                raise RuntimeError(f"variant {name!r}: {old!r} not in source")
            code = code.replace(old, new)
        libs[name] = (_build(name, code, source="sorted_segment_sum"), exact)
    print(f"device={torch.cuda.get_device_name(0)}  F={F}  device ms, mean of "
          f"{args.reps} (profiler)")
    for shape, (m, size, share) in SHAPES.items():
        keys = torch.randint(0, size, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        if share <= -100:
            keys = size // 3 + keys % int(-share)
        elif share < 0:
            keys = ((keys % int(size / -share)).float() * -share).int()
        share = max(share, 0.0)
        keys[:int(m * share)] = size // 3
        si = torch.sort(keys).values
        # integer values where one run is long: exact sums in any order
        vals = torch.randn((m, F), generator=gen, device=dev)
        if share:
            vals = torch.randint(-4, 5, (m, F), generator=gen,
                                 device=dev).float()
        stream = torch.cuda.current_stream().cuda_stream

        def call(name: str, rb: bool):
            out = torch.empty((size, F), device=dev)
            rc = libs[name][0].naruto_sorted_segment_sum(
                si.data_ptr(), vals.data_ptr(), out.data_ptr(),
                state.data_ptr(), cap, at, m, size, F, int(rb),
                stream)
            if rc:
                raise RuntimeError(f"variant {name!r} at {shape}: launch "
                                   f"failed, CUDA error {rc}")
            return out

        for rb in (True, False):
            label = f"{shape} {'bf16' if rb else 'f32 '}"
            ref = primitives.sorted_segment_sum_plain(si, vals, size,
                                                      round_bf16=rb)
            times = {name: [] for name in libs}
            for name in list(libs) + list(reversed(libs)):
                if libs[name][1]:
                    err = float((call(name, rb) - ref).abs().max()
                                / ref.abs().max())
                    if err > primitives.SEGMENT_TOL:
                        raise RuntimeError(f"variant {name!r}: error {err}")
                times[name].append(device_ms(lambda: call(name, rb),
                                              args.reps))
            for name, ts in times.items():
                print(f"{label} {name:34s} "
                      + " / ".join(f"{t:.4f}" for t in ts))
        _print_timeline(state, at, lambda: call("timeline", False), shape,
                        m)
        other = torch.empty_like(vals)
        print(f"{shape} copy of the values             "
              f"{device_ms(lambda: other.copy_(vals), args.reps):.4f}")
        print(f"{shape} plain index_add_ (f32)         " + "{:.4f}".format(
            device_ms(lambda: primitives.sorted_segment_sum_plain(
                si, vals, size, round_bf16=False), args.reps)))


if __name__ == "__main__":
    main()
