"""Probe what bounds the segment-sum kernel (csrc/sorted_segment_sum.cu) on
one NVIDIA card: the tree's kernel against variants of its source, in turns,
at the microbenchmarks' shape ([3,000,000, 8] into 201,088 slots, uniform
keys), with one key holding 60% of those rows, at the BA's shape ([93,568,
8] into 89,760 slots), that shape fed a sort permutation, and at the vertex
layout's backward ([15,789,952, 2] into the parity grid's 814,897 slots),
as sorted rows and fed the permutation.

Run:  python -m naruto_tpu_torch.scripts.probe_segment_sum [--reps N]
      [--only SUBSTRING ...]

A variant is the tree's source with text substitutions: another tile size
(stretches of at most 4 or 8 rows, for wide or narrow rows), another
way to read the permutation, or a part of the work removed (its name says
which). Each is built with the flags of ops/kernels.py into
naruto_tpu_torch/_build/probe/ (all at once; ptxas's report is printed),
called through the same entry point on the same inputs, and timed by the
profiler's device time (the mean over --reps calls), in turns: every
variant in order, then in reverse order. A variant runs on the shapes of
its kind (wide rows, narrow rows, a permutation). A variant that skips
work gives wrong results: its output is timed, never used. Variants that
keep the arithmetic are compared with the plain version. Beside them: a
device-to-device copy of the values (what the card takes to read and
write them), the plain index_add_, and where a permutation feeds the sum,
the gather by it and torch.sort of the keys.
"""
from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch

from naruto_tpu_torch.ops import kernels, primitives
from naruto_tpu_torch.scripts.probe_outer_scan import _build
from naruto_tpu_torch.scripts.trace_summary import device_ms

_SRC = kernels._CSRC / "sorted_segment_sum.cu"
_MAX_LSH = "constexpr int MAX_LSH = 4;"
_GROW = "  while (lsh < MAX_LSH && m / rows(lsh + 1) >= TARGET_TILES) ++lsh;"
_BATCH = "constexpr int BATCH = 4;"
_PUT = "    store_row<W>(out + slot * nf + col0 + j * W, v);\n"
_TICKET = "const lookback::Ticket tk = lookback::take_ticket(state);"
_SHARE = ("const unsigned share = (empty + (unsigned)ntiles - 1) / "
          "(unsigned)ntiles;")
_SMALL = "constexpr int SMALL_GAP = 32;"
_NARROW_W = ": nf == 2 && at % 8 == 0     ? 2"
_COPY = "            stage_piece<W>(dst + c, from + c, wide);"
# "timeline": thread 0 of each block stamps the global timer at eight points
# into the look-back state, from int32 word `at` on, past the words the
# kernel uses
STAMPS = ("entered", "ticket", "staged", "walked", "scanned", "published",
          "joined", "stored")
# the vertex layout's backward at office0 on configs/parity.yaml: the 16
# levels x 8 corner rows of VERTEX_POINTS points, VERTEX_SAMPLES a ray
VERTEX_POINTS, VERTEX_SAMPLES = 123_359, 43


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


def _narrow_max_lsh(lsh: int) -> tuple:
    """Stretches of at most 2^lsh rows where a thread owns a row (F = 2)."""
    return _GROW, _GROW.replace("lsh < MAX_LSH",
                                f"lsh < (W == 2 ? {lsh} : MAX_LSH)")


# name -> (substitutions, whether the output stays right, the kind of shape
# it runs on: "all", "wide" (F = 8 in order), "narrow" (F = 2) or "perm");
# the timeline's substitutions are made once the state's size is known
VARIANTS = {
    "timeline": (None, True, "all"),
    "tree": ([], True, "all"),
    "tile id from blockIdx": (
        [(_TICKET, "const lookback::Ticket tk = {(int64_t)blockIdx.x, "
          "*(volatile unsigned*)(state + 2) + 1u};")], True, "wide"),
    "first tile zeroes lead and trail": (
        [(_SHARE, "const unsigned share = t == 0 ? empty : 0;")], True,
        "wide"),
    "gaps up to 8 slots by their rows": (
        [(_SMALL, "constexpr int SMALL_GAP = 8;")], True, "wide"),
    "every gap by its row's threads": (
        [(_SMALL, "constexpr int SMALL_GAP = 0x7fffffff;")], True, "wide"),
    "stretches <= 8 rows": ([(_MAX_LSH, "constexpr int MAX_LSH = 3;")], True,
                            "wide"),
    "stretches of 4 rows": ([(_MAX_LSH, "constexpr int MAX_LSH = 2;")], True,
                            "wide"),
    "no stores": ([(_PUT, "    if (v[0] == 1.2345e-30f) out[slot] = v[0];\n")],
                  False, "all"),
    "narrow stretches of 4 rows": ([_narrow_max_lsh(2)], True, "narrow"),
    "narrow stretches <= 8 rows": ([_narrow_max_lsh(3)], True, "narrow"),
    "F = 2 one column a thread": ([(_NARROW_W, ": false ? 2")], True,
                                  "narrow"),
    "permutation through L1 and L2": ([("__ldcs(", "__ldg(")], True, "perm"),
    "permutation loads 1 a thread in flight": (
        [(_BATCH, "constexpr int BATCH = 1;")], True, "perm"),
    "permutation loads 8 a thread in flight": (
        [(_BATCH, "constexpr int BATCH = 8;")], True, "perm"),
    "permuted rows not copied": ([(_COPY, "            (void)from;")], False,
                                 "perm"),
}
# name -> (rows, slots, share of the rows in one key; or, negative, the
# number of neighbouring slots in the middle that hold every key; or,
# negative and under 100, the spacing of the slots that hold keys; or None:
# the vertex layout's keys), columns, whether a sort permutation feeds the
# rows, the rounding forms timed
SHAPES = {
    "uniform 3M": (3_000_000, 201_088, 0.0, 8, False, (True, False)),
    "one key 60% 3M": (3_000_000, 201_088, 0.6, 8, False, (True, False)),
    "BA 93,568": (93_568, 89_760, 0.0, 8, False, (True, False)),
    "BA 93,568 in 25,000 cells": (93_568, 89_760, -25_000, 8, False,
                                  (True, False)),
    "BA 93,568 in every 3.5th cell": (93_568, 89_760, -3.5, 8, False,
                                      (True, False)),
    "BA 93,568 in every 20th cell": (93_568, 89_760, -20.0, 8, False,
                                     (True, False)),
    "BA 93,568 permuted": (93_568, 89_760, 0.0, 8, True, (False,)),
    "vertex 15.8M sorted rows": (None, None, None, 2, False, (True,)),
    "vertex 15.8M permuted": (None, None, None, 2, True, (True,)),
}


def _kinds(nf: int, perm: bool) -> set:
    return {"all", "narrow" if nf < 4 else "wide"} if not perm else \
        {"all", "perm"} | ({"narrow"} if nf < 4 else set())


def vertex_keys(dev: torch.device, seed: int = 0) -> tuple:
    """The vertex backward's keys at configs/parity.yaml's office0 size:
    the corner rows ([N * 16 * 8] int32, in the encoding's order) of
    VERTEX_POINTS points along rays through the unit cube, VERTEX_SAMPLES
    a ray, as the BA samples them; and the table's row count."""
    import yaml

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.mapping.mapper import field_spec_from_config
    from naruto_tpu_torch.ops.encoding import _corner_indices

    with open(kernels._PKG.parent / "configs" / "parity.yaml") as f:
        grid = yaml.safe_load(f)["grid"]
    spec = field_spec_from_config(make_config(
        "Replica", "office0", overrides={"grid": grid})).hash_spec
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rays = -(-VERTEX_POINTS // VERTEX_SAMPLES)
    o = 0.3 + 0.4 * torch.rand((rays, 1, 3), generator=gen, device=dev)
    d = torch.nn.functional.normalize(
        torch.randn((rays, 1, 3), generator=gen, device=dev), dim=-1)
    t = torch.linspace(0.0, 0.4, VERTEX_SAMPLES, device=dev)[None, :, None]
    x = (o + d * t).clamp(0.0, 1.0).reshape(-1, 3)[:VERTEX_POINTS]
    return _corner_indices(x, spec)[0].reshape(-1), spec.total_entries


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


def _inputs(gen, dev, m, size, share, nf):
    """Sorted keys and values of a shape; integer values where one run is
    long (exact sums in any order)."""
    if share is None:
        keys, size = vertex_keys(dev)
        m = keys.shape[0]
    else:
        keys = torch.randint(0, size, (m,), generator=gen, device=dev,
                             dtype=torch.int32)
        if share <= -100:
            keys = size // 3 + keys % int(-share)
        elif share < 0:
            keys = ((keys % int(size / -share)).float() * -share).int()
        share = max(share, 0.0)
        keys[:int(m * share)] = size // 3
    vals = torch.randn((m, nf), generator=gen, device=dev)
    if share:
        vals = torch.randint(-4, 5, (m, nf), generator=gen,
                             device=dev).float()
    return keys, vals, size


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", nargs="*", default=[],
                    help="substrings of the names of the shapes to run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_segment_sum: no CUDA device; it measures the "
                         "card and does not run on the CPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = {k: v for k, v in SHAPES.items()
              if not args.only or any(s in k for s in args.only)}
    kinds = set().union(*(_kinds(v[3], v[4]) for v in shapes.values()))
    tree = _SRC.read_text()
    # one look-back state for every library, as big as the wrapper makes it
    # for the largest shape, and room for the timeline's stamps after it
    m_max = 15_789_952
    state0, cap = kernels.scan_state(torch.zeros(1, device=dev).device,
                                     m_max // 32 + 2, 2 * 8)
    at = state0.numel() + state0.numel() % 2
    state = torch.zeros(at + 16 * (m_max // 32 + 1), dtype=torch.int32,
                        device=dev)
    codes = {}
    for name, (subs, _, kind) in VARIANTS.items():
        if kind not in kinds:
            continue
        code = tree
        for old, new in subs if subs is not None else _timeline(at):
            if old not in code:
                raise RuntimeError(f"variant {name!r}: {old!r} not in source")
            code = code.replace(old, new)
        codes[name] = code
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = dict(zip(codes, pool.map(
            lambda kv: _build(kv[0], kv[1], source="sorted_segment_sum"),
            codes.items())))
    print(f"device={torch.cuda.get_device_name(0)}  device ms, mean of "
          f"{args.reps} (profiler)")
    stream = torch.cuda.current_stream().cuda_stream
    for shape, (m, size, share, nf, permuted, forms) in shapes.items():
        keys, vals, size = _inputs(gen, dev, m, size, share, nf)
        m = keys.shape[0]
        si, perm = torch.sort(keys, stable=True)
        rows = vals          # the rows in key order ...
        if permuted:         # ... or where the sort found them
            rows = torch.empty_like(vals)
            rows[perm] = vals
        libs = {name: built[name] for name in built
                if VARIANTS[name][2] in _kinds(nf, permuted)}

        def call(name: str, rb: bool):
            out = torch.empty((size, nf), device=dev)
            rc = libs[name].naruto_sorted_segment_sum(
                si.data_ptr(), rows.data_ptr(),
                perm.data_ptr() if permuted else None, out.data_ptr(),
                state.data_ptr(), cap, at, m, rows.shape[0], size, nf,
                int(rb), 1, stream)
            if rc:
                raise RuntimeError(f"variant {name!r} at {shape}: launch "
                                   f"failed, CUDA error {rc}")
            return out

        for rb in forms:
            label = f"{shape} {'bf16' if rb else 'f32 '}"
            ref = primitives.sorted_segment_sum_plain(si, vals, size,
                                                      round_bf16=rb)
            times = {name: [] for name in libs}
            for name in list(libs) + list(reversed(libs)):
                if VARIANTS[name][1]:
                    err = float((call(name, rb) - ref).abs().max()
                                / ref.abs().max())
                    if err > primitives.SEGMENT_TOL:
                        raise RuntimeError(f"variant {name!r}: error {err}")
                times[name].append(device_ms(lambda: call(name, rb),
                                              args.reps))
            for name, ts in times.items():
                print(f"{label} {name:40s} "
                      + " / ".join(f"{t:.4f}" for t in ts))
        _print_timeline(state, at, lambda: call("timeline", forms[-1]), shape,
                        m)
        other = torch.empty_like(vals)
        print(f"{shape} copy of the values             "
              f"{device_ms(lambda: other.copy_(vals), args.reps):.4f}")
        print(f"{shape} plain index_add_ (f32)         " + "{:.4f}".format(
            device_ms(lambda: primitives.sorted_segment_sum_plain(
                si, vals, size, round_bf16=False), args.reps)))
        if permuted:
            print(f"{shape} gather_rows by the permutation " + "{:.4f}".format(
                device_ms(lambda: primitives.gather_rows(rows, perm),
                          args.reps)))
            print(f"{shape} torch.sort of the keys         " + "{:.4f}".format(
                device_ms(lambda: torch.sort(keys, stable=True), args.reps)))


if __name__ == "__main__":
    main()
