"""The vertex grid's SDF decoder input on a card: how PyTorch's CUDA chain
rounds its steps, ``csrc/query_inputs.cu`` against that chain, and both
timed.

Run on a card:  python -m naruto_tpu_torch.scripts.probe_query_inputs
                    [--time] [--volumes] [--out FILE]

Prints, a line each:
  * the 8-corner sum of ``_blend`` (``[N, L, 8, F].sum(dim=2)``) against
    sums of the corners in fixed orders, each a chain of elementwise adds,
    one rounding each: the elements where each order differs;
  * the one-blob's division by the host scalar sigma * sqrt(2) against a
    product with its f32 reciprocal and against a true division;
  * the kernel against ``vertex_query_inputs_plain`` on the same card
    tensors (office0's 96,040 voxels, jiraiya's first 2^20-voxel chunk,
    4,913 random points with coordinates on the faces, and grids of 2 and
    4 levels with 8 and 4 bins): the elements that differ, in the hash
    columns and in the one-blob's;
  * with --time, both at jiraiya's 2^20-point chunk: CUDA events (median
    of 20) and the profiler's device time, beside the bound;
  * with --volumes, jiraiya's chunked map query (306^3 voxels) through the
    kernel and through the chain (the kernel refused): ms (events, median
    of 3), the peak memory over the query, the sha256 of both volumes;
    then the kernel's query at chunks of 2^18 to 2^22 points.
Exits 1 where the kernel differs from the chain by one bit. --out also
writes the lines as JSON.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import statistics
import sys

PARITY_GRID = {"layout": "vertex", "n_levels": 16, "n_features_per_level": 2,
               "table_dtype": "float32"}
CHUNK = 1 << 20
LINES = []


def say(kind: str, **kw) -> None:
    LINES.append({"probe": kind, **kw})
    print(json.dumps(LINES[-1]), flush=True)


def scene(dataset: str, name: str, grid=PARITY_GRID):
    """(field spec, voxel grid in [0, 1]^3 as the mapper makes it) of a
    scene on the card."""
    import numpy as np
    import torch

    from naruto_tpu_torch.config import make_config
    from naruto_tpu_torch.geometry.voxel import world_grid
    from naruto_tpu_torch.mapping.mapper import field_spec_from_config

    cfg = make_config(dataset, name, overrides={"grid": grid})
    m = cfg.mapper
    g = world_grid(m.bound_np, m.voxel_size).reshape(-1, 3)
    x01 = (g - m.bound_np[:, 0]) / (m.bound_np[:, 1] - m.bound_np[:, 0])
    return field_spec_from_config(cfg), torch.from_numpy(
        np.ascontiguousarray(x01)).cuda()


def random_points(n: int, seed: int):
    """n points in [0, 1]^3, a tenth of them with a coordinate on a face (0
    or 1), where the cell clamps act."""
    import torch

    g = torch.Generator().manual_seed(seed)
    x = torch.rand(n, 3, generator=g)
    k = n // 10
    x[torch.arange(k), torch.randint(0, 3, (k,), generator=g)] = \
        torch.randint(0, 2, (k,), generator=g).float()
    x[:3] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5]])
    return x.cuda()


def random_table(spec, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    return torch.randn(spec.total_entries, spec.n_features,
                       generator=g).cuda()


def probe_sum() -> None:
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    e = torch.randn(1 << 16, 16, 8, 2, generator=g, device="cuda") * \
        torch.exp2(torch.randint(-12, 12, (1 << 16, 16, 8, 2), generator=g,
                                 device="cuda").float())
    got = e.sum(dim=2)
    c = [e[:, :, k] for k in range(8)]
    z = torch.zeros_like(c[0])
    acc = [(z + c[j]) + c[j + 4] for j in range(4)]
    orders = {
        "four_accumulators": ((acc[0] + acc[1]) + acc[2]) + acc[3],
        "sequential": ((((((c[0] + c[1]) + c[2]) + c[3]) + c[4]) + c[5])
                       + c[6]) + c[7],
        "pairwise": ((c[0] + c[1]) + (c[2] + c[3]))
        + ((c[4] + c[5]) + (c[6] + c[7])),
        "halves_strided": ((c[0] + c[4]) + (c[2] + c[6]))
        + ((c[1] + c[5]) + (c[3] + c[7])),
    }
    say("corner_sum", elements=got.numel(),
        differ={k: int((v != got).sum()) for k, v in orders.items()})


def probe_division() -> None:
    import numpy as np
    import torch

    g = torch.Generator(device="cuda").manual_seed(2)
    d = torch.rand(1 << 20, generator=g, device="cuda") * 2 - 1
    den = 1.0 / 16 * math.sqrt(2.0)
    got = d / den
    inv = float(np.float32(1.0) / np.float32(den))
    true = d / torch.tensor(np.float32(den), device="cuda")
    say("one_blob_division", elements=got.numel(),
        differ={"times_f32_reciprocal": int((d * inv != got).sum()),
                "true_division": int((true != got).sum())})


def compare(name: str, table, x, spec, n_bins: int) -> bool:
    import torch

    from naruto_tpu_torch.ops import encoding, kernels

    n0 = kernels.launch_counts()["query_inputs"]
    with torch.no_grad():
        got = encoding.vertex_query_inputs(table, x, spec, n_bins)
        want = encoding.vertex_query_inputs_plain(table, x, spec, n_bins)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["query_inputs"] - n0
    h = spec.output_dim
    diff = got != want
    say("kernel_vs_chain", case=name, shape=list(got.shape),
        launches=launches, differ=int(diff.sum()),
        differ_hash=int(diff[:, :h].sum()),
        differ_one_blob=int(diff[:, h:].sum()),
        max_abs=float((got - want).abs().max()) if got.numel() else 0.0)
    return got.shape == want.shape and not bool(diff.any()) and launches == 1


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def probe_time(table, x, spec) -> None:
    import torch

    from naruto_tpu_torch.ops import encoding
    from naruto_tpu_torch.scripts.trace_summary import device_ms

    n = x.shape[0]
    nbytes = n * (12 + 4 * (spec.output_dim + 48)) + table.numel() * 4

    def kern():
        with torch.no_grad():
            encoding.vertex_query_inputs(table, x, spec, 16)

    def plain():
        with torch.no_grad():
            encoding.vertex_query_inputs_plain(table, x, spec, 16)

    say("time", points=n, bound_ms=nbytes / 3.35e9,
        kernel_ms=cuda_ms(kern, 20), plain_ms=cuda_ms(plain, 5),
        kernel_device_ms=device_ms(kern, 5), plain_device_ms=device_ms(
            plain, 2))


def digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def probe_volumes(spec, x01) -> None:
    import torch

    from naruto_tpu_torch.mapping import field
    from naruto_tpu_torch.mapping.field import (chunked_volume_maps,
                                                init_field_params)

    params = init_field_params(spec, torch.Generator(device="cuda")
                               .manual_seed(3), "cuda")
    params["uncert_grid"].normal_(generator=torch.Generator(device="cuda")
                                  .manual_seed(4))

    def query():
        with torch.no_grad():
            return chunked_volume_maps(params, x01, spec)

    def run(form: str, chunk: int):
        field.VOLUME_CHUNK = chunk
        query()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sdf, unc = query()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        say("volumes", form=form, chunk=chunk, ms=cuda_ms(query, 3),
            peak_gib=peak / 2 ** 30, sdf=digest(sdf), uncert=digest(unc),
            band_voxels=int((unc > 0).sum()))

    saved = field.query_inputs_refusal
    run("kernel", CHUNK)
    field.query_inputs_refusal = lambda *a: "the chain, for this probe"
    run("chain", CHUNK)
    field.query_inputs_refusal = saved
    for chunk in (1 << 18, 1 << 19, 1 << 21, 1 << 22):
        run("kernel", chunk)
    field.VOLUME_CHUNK = CHUNK


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--volumes", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    from naruto_tpu_torch.ops import kernels
    from naruto_tpu_torch.ops.encoding import HashGridSpec

    if not torch.cuda.is_available():
        print("probe_query_inputs: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", name=torch.cuda.get_device_name(0),
        torch=torch.__version__, cuda=torch.version.cuda)
    kernels.lib("query_inputs")
    rec = kernels.BUILD_LOG["query_inputs"]
    say("build", seconds=rec["seconds"], ptxas=[
        ln.strip() for ln in rec["ptxas"].splitlines() if "ptxas info" in ln])
    probe_sum()
    probe_division()
    ok = True
    spec_o, x_o = scene("Replica", "office0")
    spec_j, x_j = scene("NARUTO", "jiraiya")
    t_o = random_table(spec_o.hash_spec, 5)
    t_j = random_table(spec_j.hash_spec, 6)
    ok &= compare("office0 grid", t_o, x_o, spec_o.hash_spec, 16)
    ok &= compare("jiraiya chunk", t_j, x_j[:CHUNK].contiguous(),
                  spec_j.hash_spec, 16)
    ok &= compare("random points", t_j, random_points(4913, 7),
                  spec_j.hash_spec, 16)
    for levels, bins in ((2, 8), (4, 4)):
        spec = HashGridSpec(n_levels=levels, log2_table_size=12,
                            finest_resolution=200)
        ok &= compare(f"L{levels}F2, {bins} bins", random_table(spec, 8),
                      random_points(3001, 9), spec, bins)
    if args.time:
        probe_time(t_j, x_j[:CHUNK].contiguous(), spec_j.hash_spec)
    if args.volumes:
        probe_volumes(spec_j, x_j)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(LINES, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
