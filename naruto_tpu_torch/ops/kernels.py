"""Hopper kernels of the hash-grid backward scan, their plain PyTorch
versions, launch counters and the nvcc/ctypes loader.

Counterpart of naruto_tpu/ops/pallas_kernels.py. The two CUDA kernels live
in ``naruto_tpu_torch/csrc/outer_cumsum.cu`` (its header says what bounds
them on the card and how the design answers it):

  * ``chunk_totals``  (K2, replaces ``_chunk_totals_kernel``): per 512-row
    chunk column sums of the bf16-rounded a-major outer products.
  * ``outer_cumsum``  (K1, replaces ``_outer_cumsum_kernel``): the inclusive
    row prefix sum of the same products, each chunk starting from its
    offset.

``outer_cumsum_scan`` chains them as ``pallas_kernels.outer_cumsum`` does:
K2, an exclusive cumsum of the small totals array, then K1.

Every wrapper takes its plain version for a tensor on the CPU (the tests
run there) and launches its kernel for a CUDA tensor; it never falls back.
The library is compiled from the checkout with nvcc at first use into
``naruto_tpu_torch/_build/`` and bound with ctypes.
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

from naruto_tpu_torch.ops import cumsum_rows

SUB = 512    # rows per chunk, as in pallas_kernels.SUB

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "outer_cumsum.cu"
_BUILD = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# launches of each kernel since the last reset (plain versions do not count)
LAUNCHES = {"chunk_totals": 0, "outer_cumsum": 0}
BUILD_LOG = {"seconds": None, "ptxas": ""}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the hash-grid "
                           "backward kernels need nvcc to build")
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"libouter_cumsum_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
             "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
        BUILD_LOG["ptxas"] = proc.stderr
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.naruto_chunk_totals.argtypes = [p, p, p, i64, i32, i32, p]
    lib.naruto_chunk_totals.restype = i32
    lib.naruto_outer_cumsum.argtypes = [p, p, p, p, i64, i32, i32, p]
    lib.naruto_outer_cumsum.restype = i32
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    return lib


def build() -> dict:
    """Build and load the kernels now; returns BUILD_LOG (seconds, ptxas)."""
    _lib()
    return dict(BUILD_LOG)


def _check(sa: torch.Tensor, sb: torch.Tensor) -> tuple:
    if sa.dtype != torch.bfloat16 or sb.dtype != torch.bfloat16:
        raise TypeError(f"factors must be bfloat16, got {sa.dtype}/{sb.dtype}")
    if sa.dim() != 2 or sb.dim() != 2 or sa.shape[0] != sb.shape[0]:
        raise ValueError(f"factor shapes {tuple(sa.shape)} / "
                         f"{tuple(sb.shape)} must be [M, ka] / [M, kb]")
    m, ka = sa.shape
    kb = sb.shape[1]
    if m % SUB:
        raise ValueError(f"M={m} must be a multiple of {SUB}")
    if sa.device != sb.device:
        raise ValueError(f"factors on {sa.device} and {sb.device}")
    return m, ka, kb


def _check_cuda(m: int, ka: int, kb: int, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not (0 < ka * kb <= 256 and ka + kb <= 48):
        raise ValueError(f"kernel takes ka*kb <= 256 and ka+kb <= 48; "
                         f"got ka={ka}, kb={kb}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16-byte "
                             "aligned and on one device")


def _outer_terms(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """[M, ka*kb] f32 of the bf16-rounded a-major outer products."""
    m = sa.shape[0]
    return (sa[:, :, None] * sb[:, None, :]).float().reshape(m, -1)


def chunk_totals_plain(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    m, ka, kb = _check(sa, sb)
    return _outer_terms(sa, sb).view(m // SUB, SUB, ka * kb).sum(dim=1)


def outer_cumsum_plain(sa: torch.Tensor, sb: torch.Tensor,
                       offs: torch.Tensor) -> torch.Tensor:
    m, ka, kb = _check(sa, sb)
    cs = _outer_terms(sa, sb).view(m // SUB, SUB, ka * kb).cumsum(dim=1)
    return (cs + offs[:, None, :]).reshape(m, ka * kb)


def chunk_totals(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """K2: [M, ka] x [M, kb] bf16 -> [M/512, ka*kb] f32 chunk totals."""
    m, ka, kb = _check(sa, sb)
    if sa.device.type == "cpu":
        return chunk_totals_plain(sa, sb)
    _check_cuda(m, ka, kb, sa, sb)
    tot = torch.empty((m // SUB, ka * kb), dtype=torch.float32,
                      device=sa.device)
    with torch.cuda.device(sa.device):
        rc = _lib().naruto_chunk_totals(
            sa.data_ptr(), sb.data_ptr(), tot.data_ptr(), m, ka, kb,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"chunk_totals kernel launch failed: CUDA error {rc}")
    LAUNCHES["chunk_totals"] += 1
    return tot


def outer_cumsum(sa: torch.Tensor, sb: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """K1: inclusive per-chunk prefix sums of the outer-product rows, each
    chunk starting from offs [M/512, ka*kb] -> [M, ka*kb] f32."""
    m, ka, kb = _check(sa, sb)
    if offs.shape != (m // SUB, ka * kb) or offs.dtype != torch.float32:
        raise ValueError(f"offs must be float32 [{m // SUB}, {ka * kb}], got "
                         f"{offs.dtype} {tuple(offs.shape)}")
    if sa.device.type == "cpu":
        return outer_cumsum_plain(sa, sb, offs)
    _check_cuda(m, ka, kb, sa, sb, offs)
    out = torch.empty((m, ka * kb), dtype=torch.float32, device=sa.device)
    with torch.cuda.device(sa.device):
        rc = _lib().naruto_outer_cumsum(
            sa.data_ptr(), sb.data_ptr(), offs.data_ptr(), out.data_ptr(),
            m, ka, kb, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"outer_cumsum kernel launch failed: CUDA error {rc}")
    LAUNCHES["outer_cumsum"] += 1
    return out


def outer_cumsum_scan(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of outer(sa[i], sb[i]) flattened rows over all
    M rows (counterpart of pallas_kernels.outer_cumsum): K2, the exclusive
    cumsum of its totals, then K1."""
    totals = chunk_totals(sa, sb)
    offs = cumsum_rows(totals) - totals
    return outer_cumsum(sa, sb, offs)
