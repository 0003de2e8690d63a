"""The Hopper kernel of the hash-grid backward scan, its plain PyTorch
versions, launch counters, the look-back state of the one-pass scans and the
nvcc/ctypes loader of every kernel of the port.

Counterpart of naruto_tpu/ops/pallas_kernels.py. Its two Pallas kernels
(K1 ``_outer_cumsum_kernel``, K2 ``_chunk_totals_kernel``) and the exclusive
cumsum between them are one CUDA kernel, ``naruto_tpu_torch/csrc/
outer_cumsum.cu`` (its header says what bounds it on the card and how the
design answers it), with two store epilogues:

  * ``outer_cumsum_scan``: the inclusive row prefix sum of the bf16-rounded
    a-major outer products, [M, ka*kb] (``pallas_kernels.outer_cumsum``).
  * ``outer_cumsum_slots``: from sorted keys, row t of [size, ka*kb] holds
    the prefix sum through the last update with key <= t: what the hash
    backward needs, without the [M, ka*kb] prefix sum in device memory.

The kernels of the hash-grid microbenchmarks are wrapped in
``ops/primitives.py``.

Every wrapper takes its plain version for a tensor on the CPU (the tests
run there) and launches its kernel for a CUDA tensor; it never falls back.
Each ``csrc/<source>.cu`` is compiled from the checkout with nvcc at first
use (``build()`` compiles all of them at once, one nvcc each) into
``naruto_tpu_torch/_build/``, keyed by a hash of the sources and the flags,
and bound with ctypes. ``launch`` is the one host path of every wrapper:
one foreign call on the raw handle of the current stream, with a device
guard only when the tensor's card is not the current one.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

SUB = 512    # rows per chunk, as in pallas_kernels.SUB
_INT32_MAX = 2 ** 31 - 1

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the C entry points of each csrc/<source>.cu: name -> (argtypes, restype)
ENTRY_POINTS = {
    "outer_cumsum": {
        "naruto_outer_scan_rows": (
            [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P], _I32),
        "naruto_outer_scan_slots": (
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P],
            _I32)},
    "gather_rows": {
        "naruto_gather_rows": ([_P, _P, _P, _I64, _I64, _I32, _I32, _P],
                               _I32)},
    "sorted_segment_sum": {
        "naruto_sorted_segment_sum": (
            [_P, _P, _P, _P, _I64, _I64, _I64, _I32, _I32, _I32, _P], _I32)},
    "row_cumsum": {
        "naruto_row_cumsum": ([_P, _P, _P, _I64, _I64, _I64, _I32, _P],
                              _I32)},
}

# launches of each entry point since the last reset (plain versions do not
# count); the fused scan counts each epilogue apart
LAUNCHES = {"outer_scan_rows": 0, "outer_scan_slots": 0, "gather_rows": 0,
            "sorted_segment_sum": 0, "row_cumsum": 0}
# per source: nvcc's wall seconds (None: the library was already built) and
# its -Xptxas=-v report
BUILD_LOG = {src: {"seconds": None, "ptxas": ""} for src in ENTRY_POINTS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _library_path(src: str) -> Path:
    # the shared headers are part of every source's key
    code = b"".join(path.read_bytes() for path in
                    [_CSRC / f"{src}.cu", *sorted(_CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(code + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return _BUILD / f"lib{src}_{tag[:16]}.so"


def _compile(sources) -> None:
    """Start one nvcc for each source whose library is missing, all at
    once, and wait for every one of them before reporting a failure."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the port's "
                           "kernels need nvcc to build")
    jobs = []
    for src in sources:
        so = _library_path(src)
        if so.exists():
            continue
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
             "-o", str(tmp), str(_CSRC / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, proc, tmp, so, time.perf_counter()))
    failed = []
    for src, proc, tmp, so, t0 in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{src}.cu:\n{err}")
            continue
        BUILD_LOG[src] = {"seconds": time.perf_counter() - t0, "ptxas": err}
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.lru_cache(maxsize=None)
def lib(src: str) -> ctypes.CDLL:
    """The library of csrc/<src>.cu, compiled once per content, with the
    argument and result types of its entry points set."""
    _compile((src,))
    cdll = ctypes.CDLL(str(_library_path(src)))
    for fn, (argtypes, restype) in ENTRY_POINTS[src].items():
        getattr(cdll, fn).argtypes = argtypes
        getattr(cdll, fn).restype = restype
    return cdll


def build() -> dict:
    """Build (in parallel) and load every kernel library now; returns
    BUILD_LOG."""
    _compile(tuple(ENTRY_POINTS))
    for src in ENTRY_POINTS:
        lib(src)
    return {src: dict(v) for src, v in BUILD_LOG.items()}


def launch(name: str, fn, device: torch.device, *args) -> None:
    """fn(*args, stream): one call of a C entry point on the current stream
    of `device` (a CUDA device), which must return 0; counts one launch of
    kernel `name`."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# As GROUP, HEADER and state_words in csrc/lookback.cuh, which checks the
# state it is given against them.
_SCAN_GROUP, _SCAN_HEADER = 32, 4
_SCAN_MIN_CAP, _SCAN_MIN_FLOATS = 16384, 1 << 18
# (device index, raw stream) -> (zeroed int32 state buffer, tile capacity)
_SCAN_STATES: dict = {}


def scan_state(dev: torch.device, tiles: int, nf: int) -> tuple:
    """The look-back state of the tiled one-pass kernels (row_cumsum, the
    fused outer scan, sorted_segment_sum) for the current stream of `dev`,
    and its capacity in tiles:
    made zeroed (one fill) at the stream's first call and when a call of
    `tiles` tiles of nf floats needs more room; each kernel leaves it ready
    for the next call itself."""
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    floats = (tiles + tiles // _SCAN_GROUP) * nf
    buf, cap = _SCAN_STATES.get(key, (None, 0))
    if buf is None or tiles > cap or \
            _SCAN_HEADER + cap + cap // _SCAN_GROUP + 1 + floats > buf.numel():
        cap = max(2 * tiles, cap, _SCAN_MIN_CAP)
        words = _SCAN_HEADER + cap + cap // _SCAN_GROUP + 1 + max(
            2 * floats, _SCAN_MIN_FLOATS)
        buf = torch.zeros(words, dtype=torch.int32, device=dev)
        _SCAN_STATES[key] = (buf, cap)
    return buf, cap


def _check(sa: torch.Tensor, sb: torch.Tensor) -> tuple:
    if sa.dtype != torch.bfloat16 or sb.dtype != torch.bfloat16:
        raise TypeError(f"factors must be bfloat16, got {sa.dtype}/{sb.dtype}")
    if sa.dim() != 2 or sb.dim() != 2 or sa.shape[0] != sb.shape[0]:
        raise ValueError(f"factor shapes {tuple(sa.shape)} / "
                         f"{tuple(sb.shape)} must be [M, ka] / [M, kb]")
    m, ka = sa.shape
    kb = sb.shape[1]
    if m % SUB or not m:
        raise ValueError(f"M={m} must be a positive multiple of {SUB}")
    if sa.device != sb.device:
        raise ValueError(f"factors on {sa.device} and {sb.device}")
    return m, ka, kb


def _check_cuda(ka: int, kb: int, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (0 < ka * kb <= 128 and kb % 2 == 0 and ka + kb <= 32):
        raise ValueError(f"kernel takes ka*kb <= 128, an even kb and "
                         f"ka+kb <= 32; got ka={ka}, kb={kb}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned and on one device")


def _outer_terms(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """[M, ka*kb] f32 of the bf16-rounded a-major outer products."""
    m = sa.shape[0]
    return (sa[:, :, None] * sb[:, None, :]).float().reshape(m, -1)


def outer_cumsum_scan_plain(sa: torch.Tensor,
                            sb: torch.Tensor) -> torch.Tensor:
    """As pallas_kernels.outer_cumsum: per-chunk prefix sums, each chunk
    starting from the exclusive cumsum of the chunk totals. The offsets are
    summed in f64 and rounded once: an f32 cumsum over ~1,000 chunks drifts
    by ~10 ulps of the running sum (~1e-6 of max|cumsum| at the BA's M),
    as much as the kernel may differ from this reference."""
    m, ka, kb = _check(sa, sb)
    cs = _outer_terms(sa, sb).view(m // SUB, SUB, ka * kb).cumsum(dim=1)
    tot = cs[:, -1].double()
    offs = (torch.cumsum(tot, 0) - tot).float()
    return (cs + offs[:, None, :]).reshape(m, ka * kb)


def _check_keys(si: torch.Tensor, m: int, size: int) -> None:
    if si.dtype != torch.int32 or si.shape != (m,):
        raise ValueError(f"keys must be int32 [{m}], got {si.dtype} "
                         f"{tuple(si.shape)}")
    if not 0 <= size < _INT32_MAX:
        raise ValueError(f"size {size} out of range")


def outer_cumsum_slots_plain(si: torch.Tensor, sa: torch.Tensor,
                             sb: torch.Tensor, size: int) -> torch.Tensor:
    """hi[t] = outer_cumsum_scan_plain(sa, sb)[ub[t] - 1], ub[t] = #{keys
    <= t}, and 0 where ub[t] = 0: a rank search, a boundary gather and a
    select over the full prefix sum."""
    m, _, _ = _check(sa, sb)
    _check_keys(si, m, size)
    cs = outer_cumsum_scan_plain(sa, sb)
    ub = torch.searchsorted(
        si, torch.arange(size, dtype=si.dtype, device=si.device), right=True)
    return torch.where((ub > 0)[:, None],
                       cs.index_select(0, (ub - 1).clamp(min=0)), 0.0)


def outer_cumsum_scan(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of the flattened rows outer(sa[i], sb[i]) over
    all M rows, [M, ka] x [M, kb] bf16 -> [M, ka*kb] f32 (counterpart of
    pallas_kernels.outer_cumsum), in one launch; two calls on the same
    input agree bit for bit."""
    m, ka, kb = _check(sa, sb)
    if not sa.is_cuda:
        return outer_cumsum_scan_plain(sa, sb)
    _check_cuda(ka, kb, sa, sb)
    out = torch.empty((m, ka * kb), dtype=torch.float32, device=sa.device)
    state, cap = scan_state(sa.device, m // SUB, ka * kb)
    launch("outer_scan_rows", lib("outer_cumsum").naruto_outer_scan_rows,
           sa.device, sa.data_ptr(), sb.data_ptr(), out.data_ptr(),
           state.data_ptr(), cap, state.numel(), m, ka, kb)
    return out


def outer_cumsum_slots(si: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor,
                       size: int) -> torch.Tensor:
    """outer_cumsum_slots_plain in one launch: si [M] int32 sorted
    ascending, sa [M, ka] / sb [M, kb] bf16 in the same order -> [size,
    ka*kb] f32 with row t the prefix sum through the last row whose key is
    <= t (0 before the first key). Keys >= size (the INT32_MAX pads) add to
    no row. Two calls on the same input agree bit for bit."""
    m, ka, kb = _check(sa, sb)
    _check_keys(si, m, size)
    if not sa.is_cuda:
        return outer_cumsum_slots_plain(si, sa, sb, size)
    _check_cuda(ka, kb, sa, sb, si)
    hi = torch.empty((size, ka * kb), dtype=torch.float32, device=sa.device)
    if size:
        state, cap = scan_state(sa.device, m // SUB, ka * kb)
        launch("outer_scan_slots", lib("outer_cumsum").naruto_outer_scan_slots,
               sa.device, si.data_ptr(), sa.data_ptr(), sb.data_ptr(),
               hi.data_ptr(), state.data_ptr(), cap, state.numel(), m, ka, kb,
               size)
    return hi
