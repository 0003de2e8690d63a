"""Probe what bounds the fused hash-backward scan (csrc/outer_cumsum.cu) on
one NVIDIA card: the tree's kernel against variants of its source, in turns,
at the mapping step's office0 shape (M = 493,568 rows, 8x8, 204,089 slots).

Run:  python -m naruto_tpu_torch.scripts.probe_outer_scan [--reps N]
          [--also FILE.cu ...]

A variant is the tree's source with text substitutions (its name says what
it removes or changes), or another source file given with --also that has
the same C entry points, built where it lies. Each is built with the flags
of ops/kernels.py into naruto_tpu_torch/_build/probe/ (ptxas's report is
printed), called
through the same entry points on the same inputs, and timed by the
profiler's device time (the mean over --reps calls), in turns: every
variant in order, then in reverse order. A variant that skips work gives
wrong results: its output is timed, never used. Variants made by
substitution that keep the arithmetic are compared with the tree's output,
bit for bit. The "timeline" variant also prints, for one call, when the
blocks reached each phase of the scan (the global timer, in us).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
from pathlib import Path

import torch

from naruto_tpu_torch.ops import kernels
from naruto_tpu_torch.scripts.trace_summary import device_ms

M_REAL, M, SLOTS, K = 493_436, 493_568, 204_089, 8
_PKG = Path(kernels.__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "outer_cumsum.cu"
_OUT = _PKG / "_build" / "probe"

_PASS1 = "      for (int j = 0; j < W; ++j) run[j] += v[j];\n"
_LOOKBACK = ("lookback::exclusive_offset(state, cap, nch, t, tk.mark,\n"
             + " " * 47 + "ncol, agg, part)")
_ROW_STORE = "store_row<W>(out + (row0 + r) * ncol + col0, o);"
_SLOT_STORE = "store_row<W>(out + (int64_t)u * ncol + col0, o);"
_SINK = "if (o[0] == 1.2345e-30f) out[0] = o[1];"
# "timeline": thread 0 of each block stamps the global timer at five points
# (ticket taken, chunk staged, chunk totals ready, offset known, stores
# issued) into the look-back state, from int32 word `at` on, past the words
# the scan uses
STAMPS = ("ticket", "staged", "totals", "offset", "stored")


def _timeline(at: int) -> list:
    return [
        ('#include "lookback.cuh"\n',
         '#include "lookback.cuh"\n'
         "__device__ __forceinline__ void stamp(unsigned* s, int64_t t,\n"
         "                                      int k) {\n"
         "  if (threadIdx.x) return;\n"
         "  unsigned long long ts;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ts));\n'
         f"  reinterpret_cast<unsigned long long*>(s + {at})[t * 8 + k] ="
         " ts;\n"
         "}\n"),
        ("  const int64_t row0 = t * CHUNK;\n",
         "  const int64_t row0 = t * CHUNK;\n  stamp(state, t, 0);\n"),
        ("  }\n  __syncthreads();\n\n  // thread: the W columns",
         "  }\n  __syncthreads();\n  stamp(state, t, 1);\n\n"
         "  // thread: the W columns"),
        ("  const float off = lookback::",
         "  stamp(state, t, 2);\n  const float off = lookback::"),
        ("  if (tid < ncol) offs[tid] = off;\n  __syncthreads();\n",
         "  if (tid < ncol) offs[tid] = off;\n  __syncthreads();\n"
         "  stamp(state, t, 3);\n"),
        ("  if (tid == 0) lookback::finish(",
         "  stamp(state, t, 4);\n  if (tid == 0) lookback::finish("),
    ]


# name -> (substitutions, whether the output stays exact); the timeline's
# substitutions are made once the state's size is known
VARIANTS = {
    "timeline": (None, True),
    "tree": ([], True),
    "no look-back (offset 0)": ([(_LOOKBACK, "0.0f * agg")], False),
    "no stores": ([(_ROW_STORE, _SINK), (_SLOT_STORE, _SINK)], False),
    "no first pass (totals 0)": ([(_PASS1, "")], False),
}


def _build(name: str, code: str | None = None, path: Path | None = None,
           source: str = "outer_cumsum") -> ctypes.CDLL:
    """The library of `path`, or of `code` written beside the tree's
    headers, with the entry points of csrc/<source>.cu."""
    from torch.utils.cpp_extension import CUDA_HOME

    _OUT.mkdir(parents=True, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu = path or _SRC.parent / f".probe_{tag}.cu"
    if code is not None:
        cu.write_text(code)
    so = _OUT / f"lib{source}_{tag}.so"
    try:
        run = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *kernels.NVCC_FLAGS,
             "-o", str(so), str(cu)], capture_output=True, text=True)
    finally:
        if code is not None:
            cu.unlink()
    if run.returncode:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{run.stderr}")
    for line in sorted({ln.strip() for ln in run.stderr.splitlines()
                        if "registers" in ln or "spill" in ln}):
        print(f"  [{name}] {line}")
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, rtype) in kernels.ENTRY_POINTS[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = rtype
    return lib


def _print_timeline(state: torch.Tensor, at: int, call, slots: bool) -> None:
    """One call of the timeline variant: when each block reached each
    stamp, in us from the first block's ticket (quantiles over blocks), and
    how long each phase took."""
    call("timeline", slots)
    torch.cuda.synchronize()
    nch = M // kernels.SUB
    ts = state[at:at + 16 * nch].view(torch.int64).view(
        nch, 8)[:, :len(STAMPS)].double().cpu()
    ts = (ts - ts[:, 0].min()) / 1e3
    q = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0], dtype=torch.float64)
    label = "slots" if slots else "rows "
    for k, name in enumerate(STAMPS):
        print(f"{label} timeline {name:8s} at us (min/p10/p50/p90/max): "
              + " / ".join(f"{v:.2f}" for v in torch.quantile(ts[:, k], q)))
    for k in range(1, len(STAMPS)):
        d = ts[:, k] - ts[:, k - 1]
        print(f"{label} timeline {STAMPS[k - 1]} -> {STAMPS[k]} us "
              f"(min/p10/p50/p90/max): "
              + " / ".join(f"{v:.2f}" for v in torch.quantile(d, q)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--also", nargs="*", default=[], metavar="FILE.cu",
                    help="other sources with the same entry points, built "
                         "where they lie (with the headers beside them)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_outer_scan: no CUDA device; it measures the "
                         "card and does not run on the CPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    keys = torch.randint(0, SLOTS, (M_REAL,), generator=gen, device=dev,
                         dtype=torch.int32)
    si = torch.cat([torch.sort(keys).values,
                    torch.full((M - M_REAL,), 2 ** 31 - 1, dtype=torch.int32,
                               device=dev)])
    sa = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    sb = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    sa[M_REAL:] = 0
    sb[M_REAL:] = 0
    # each library its own look-back state, as big as the tree's wrappers
    # make it, and room for the timeline's stamps after it
    state0, cap = kernels.scan_state(sa.device, M // kernels.SUB, K * K)
    at = state0.numel() + state0.numel() % 2
    tree = _SRC.read_text()
    libs = {}
    for name, (subs, exact) in VARIANTS.items():
        code = tree
        for old, new in subs if subs is not None else _timeline(at):
            if old not in code:
                raise RuntimeError(f"variant {name!r}: {old!r} not in source")
            code = code.replace(old, new)
        libs[name] = (_build(name, code), exact)
    for path in args.also:
        libs[path] = (_build(path, path=Path(path)), False)
    states = {name: torch.zeros(at + 16 * (M // kernels.SUB),
                                dtype=torch.int32, device=dev)
              for name in libs}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call(name: str, slots: bool):
        lib, state = libs[name][0], states[name]
        out = torch.empty((SLOTS if slots else M, K * K), device=dev)
        if slots:
            rc = lib.naruto_outer_scan_slots(
                si.data_ptr(), sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                state.data_ptr(), cap, state.numel(), M, K, K, SLOTS,
                stream())
        else:
            rc = lib.naruto_outer_scan_rows(
                sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
                state.data_ptr(), cap, state.numel(), M, K, K, stream())
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    print(f"device={torch.cuda.get_device_name(0)}  M={M} {K}x{K} "
          f"slots={SLOTS}  device ms, mean of {args.reps} (profiler)")
    for slots in (False, True):
        ref = call("tree", slots)
        times = {name: [] for name in libs}
        order = list(libs) + list(reversed(libs))
        for name in order:
            if libs[name][1] and not torch.equal(call(name, slots), ref):
                raise RuntimeError(f"variant {name!r} changed the output")
            times[name].append(device_ms(lambda: call(name, slots),
                                          args.reps))
        for name, ts in times.items():
            print(f"{'slots' if slots else 'rows '} {name:40s} "
                  + " / ".join(f"{t:.4f}" for t in ts))
        _print_timeline(states["timeline"], at, call, slots)


if __name__ == "__main__":
    main()
