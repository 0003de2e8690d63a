"""Hopper kernels of the hash-grid microbenchmarks, with their plain
PyTorch versions.

Counterparts of the seven Pallas kernels of scripts/microbench_primitives.py
and scripts/microbench_round2.py, which compute three functions:

  * ``gather_rows``         (P2 ``take_kernel``, P3 ``take_kernel2``,
    P5 ``k_taa_bcast``, P6 ``k_take_1d``): ``csrc/gather_rows.cu``.
  * ``sorted_segment_sum``  (P1 ``seg_kernel`` with ``round_bf16=True``,
    P7 ``make_seg.<seg_kernel>`` with ``round_bf16=False``):
    ``csrc/sorted_segment_sum.cu``.
  * ``row_cumsum``          (P4 ``cs_kernel``): ``csrc/row_cumsum.cu``.

Each source's header says what bounds the kernel on the card and how its
design answers it. As in ``ops/kernels.py``, every wrapper checks what it
is given and raises on what its kernel does not take, runs the plain
version for a tensor on the CPU, launches the kernel for a CUDA tensor
(never falling back), and counts its launches in ``kernels.LAUNCHES``.
"""
from __future__ import annotations

import torch

from naruto_tpu_torch.ops import cumsum_rows
from naruto_tpu_torch.ops.kernels import LAUNCHES, lib

# Tolerances of each kernel against its plain version on the same card
# tensors, as a share of max|plain|, and the reason for each:
GATHER_TOL = 0.0       # a copy: bit-exact
SEGMENT_TOL = 1e-6     # the plain index_add_ sums through atomics, in an
                       # order that changes from run to run
CUMSUM_TOL = 1e-5      # f32 sums in another order over a random walk of up
                       # to 3M rows (the kernel: chunks of rows; torch: its
                       # own scan tree)
ROW_CUMSUM_MAX_F = 256
_INT32_MAX = 2 ** 31 - 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _device(*tensors: torch.Tensor) -> str:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev.type


def _launched(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# ------------------------------------------------------------------ gather
def _check_gather(tbl: torch.Tensor, idx: torch.Tensor) -> str:
    if tbl.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"table must be bfloat16 or float32, got {tbl.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table {tuple(tbl.shape)} / indices "
                         f"{tuple(idx.shape)} must be [TS, W] / [M]")
    if not 0 < tbl.shape[0] <= _INT32_MAX or tbl.shape[1] < 1:
        raise ValueError(f"table shape {tuple(tbl.shape)} out of range")
    _contiguous(tbl, idx)
    return _device(tbl, idx)


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl.index_select(0, idx)


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = tbl[idx[i], :]: [TS, W] bf16/f32 table, [M] int32
    indices in [0, TS) -> [M, W] (any M, any W, bit-exact)."""
    if _check_gather(tbl, idx) == "cpu":
        return gather_rows_plain(tbl, idx)
    out = torch.empty((idx.shape[0], tbl.shape[1]), dtype=tbl.dtype,
                      device=tbl.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tbl.device):
        rc = lib("gather_rows").naruto_gather_rows(
            tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            tbl.shape[0], tbl.shape[1] * tbl.element_size(), _stream(tbl))
    _launched("gather_rows", rc)
    return out


# ------------------------------------------------------------- segment sum
def _check_segment(si: torch.Tensor, vals: torch.Tensor, size: int) -> str:
    if si.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {si.dtype}")
    if vals.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {vals.dtype}")
    if si.dim() != 1 or vals.dim() != 2 or vals.shape[0] != si.shape[0] \
            or vals.shape[1] < 1:
        raise ValueError(f"keys {tuple(si.shape)} / values "
                         f"{tuple(vals.shape)} must be [M] / [M, F]")
    if not 0 <= size < _INT32_MAX:
        raise ValueError(f"size {size} out of range")
    _contiguous(si, vals)
    return _device(si, vals)


def sorted_segment_sum_plain(si: torch.Tensor, vals: torch.Tensor, size: int,
                             *, round_bf16: bool) -> torch.Tensor:
    v = vals.to(torch.bfloat16).float() if round_bf16 else vals
    return vals.new_zeros((size, vals.shape[1])).index_add_(0, si, v)


def sorted_segment_sum(si: torch.Tensor, vals: torch.Tensor, size: int, *,
                       round_bf16: bool) -> torch.Tensor:
    """out[s] = sum of r(vals[i]) over i with si[i] == s, in f32: si [M]
    int32 sorted ascending with keys in [0, size), vals [M, F] f32 ->
    [size, F] f32; r rounds to bf16 (round_bf16) or is the identity."""
    if _check_segment(si, vals, size) == "cpu":
        return sorted_segment_sum_plain(si, vals, size, round_bf16=round_bf16)
    out = torch.empty((size, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(vals.device):
        rc = lib("sorted_segment_sum").naruto_sorted_segment_sum(
            si.data_ptr(), vals.data_ptr(), out.data_ptr(), si.shape[0],
            size, vals.shape[1], int(round_bf16), _stream(vals))
    _launched("sorted_segment_sum", rc)
    return out


# ---------------------------------------------------------------- row scan
def _check_cumsum(x: torch.Tensor) -> str:
    if x.dtype != torch.float32:
        raise TypeError(f"row_cumsum takes float32, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[1] <= ROW_CUMSUM_MAX_F:
        raise ValueError(f"row_cumsum takes [M, F] with 1 <= F <= "
                         f"{ROW_CUMSUM_MAX_F}, got {tuple(x.shape)}")
    _contiguous(x)
    return _device(x)


def row_cumsum_plain(x: torch.Tensor) -> torch.Tensor:
    return cumsum_rows(x)


def row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the rows of [M, F] f32 (any M, F <= 256)."""
    if _check_cumsum(x) == "cpu":
        return row_cumsum_plain(x)
    m, nf = x.shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    with torch.cuda.device(x.device):
        k = lib("row_cumsum")
        scratch = torch.empty((2, k.naruto_row_cumsum_chunks(m, nf), nf),
                              dtype=torch.float32, device=x.device)
        rc = k.naruto_row_cumsum(x.data_ptr(), scratch[0].data_ptr(),
                                 scratch[1].data_ptr(), out.data_ptr(), m, nf,
                                 _stream(x))
    _launched("row_cumsum", rc)
    return out
