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

``gather_rows`` and ``sorted_segment_sum`` also carry the mapper's BA path:
the hash grid's forward gather, the cell-row backward's payload gathers,
and the segment sums of the vertex layout's backward and of the
uncertainty grid's trilinear VJP (``sorted_segment_sum`` fed the sort
permutation, which reads each row from its place: no gather).

Each source's header says what bounds the kernel on the card and how its
design answers it. As in ``ops/kernels.py``, every wrapper checks the
metadata of what it is given and raises on what its kernel does not take,
runs the plain version for a tensor on the CPU, launches the kernel for a
CUDA tensor with one foreign call (``kernels.launch``; never falling
back), and counts its launches in ``kernels.LAUNCHES``.
"""
from __future__ import annotations

import torch

from naruto_tpu_torch.ops import cumsum_rows
from naruto_tpu_torch.ops.kernels import launch, lib, scan_state

# Tolerances of each kernel against its plain version on the same card
# tensors, as a share of max|plain|, and the reason for each:
GATHER_TOL = 0.0       # a copy: bit-exact
SEGMENT_TOL = 1e-6     # the plain index_add_ sums through atomics, in an
                       # order that changes from run to run (the kernel's
                       # order is fixed: two calls agree bit for bit)
CUMSUM_TOL = 1e-5      # f32 sums in another order over a random walk of up
                       # to 3M rows (the kernel: chunks of rows; torch: its
                       # own scan tree)
ROW_CUMSUM_MAX_F = 256
_INT32_MAX = 2 ** 31 - 1
GATHER_TABLE_DTYPES = (torch.bfloat16, torch.float32, torch.int32)
GATHER_INDEX_DTYPES = (torch.int32, torch.int64)


def _contiguous(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")


def _device(first: torch.Tensor, *rest: torch.Tensor) -> torch.device:
    dev = first.device
    for t in rest:
        if t.device != dev:
            raise ValueError(f"operands on "
                             f"{[str(t.device) for t in (first, *rest)]}")
    if not first.is_cuda and dev.type != "cpu":
        raise ValueError(f"no kernel for device {dev}")
    return dev


# ------------------------------------------------------------------ gather
def _check_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.device:
    if tbl.dtype not in GATHER_TABLE_DTYPES:
        raise TypeError(f"table must be bfloat16, float32 or int32, got "
                        f"{tbl.dtype}")
    if idx.dtype not in GATHER_INDEX_DTYPES:
        raise TypeError(f"indices must be int32 or int64, got {idx.dtype}")
    if tbl.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"table {tuple(tbl.shape)} / indices "
                         f"{tuple(idx.shape)} must be [TS, W] / [M]")
    ts, w = tbl.shape
    if not ts or not w:
        raise ValueError(f"table shape {tuple(tbl.shape)} out of range")
    _contiguous(tbl, idx)
    return _device(tbl, idx)


def gather_rows_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl.index_select(0, idx)


def gather_rows(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i, :] = tbl[idx[i], :]: [TS, W] bf16/f32/int32 table, [M] int32
    or int64 indices in [0, TS) -> [M, W] (any M, any W, bit-exact)."""
    dev = _check_gather(tbl, idx)
    if not tbl.is_cuda:
        return gather_rows_plain(tbl, idx)
    m = idx.shape[0]
    ts, w = tbl.shape
    out = tbl.new_empty((m, w))
    if m:
        launch("gather_rows", lib("gather_rows").naruto_gather_rows, dev,
               tbl.data_ptr(), idx.data_ptr(), out.data_ptr(), m, ts,
               w * tbl.element_size(), idx.dtype == torch.int64)
    return out


# ------------------------------------------------------------- segment sum
def _check_segment(si: torch.Tensor, vals: torch.Tensor, size: int,
                   perm) -> torch.device:
    if si.dtype != torch.int32:
        raise TypeError(f"keys must be int32, got {si.dtype}")
    if vals.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {vals.dtype}")
    if si.dim() != 1 or vals.dim() != 2 or vals.shape[1] < 1 \
            or (perm is None and vals.shape[0] != si.shape[0]):
        raise ValueError(f"keys {tuple(si.shape)} / values "
                         f"{tuple(vals.shape)} must be [M] / [M, F]")
    if not 0 <= size < _INT32_MAX:
        raise ValueError(f"size {size} out of range")
    operands = (si, vals)
    if perm is not None:
        if perm.dtype not in GATHER_INDEX_DTYPES:
            raise TypeError(f"perm must be int32 or int64, got {perm.dtype}")
        if perm.shape != si.shape:
            raise ValueError(f"perm {tuple(perm.shape)} must be [M] as the "
                             f"keys {tuple(si.shape)}")
        operands += (perm,)
    _contiguous(*operands)
    return _device(*operands)


def sorted_segment_sum_plain(si: torch.Tensor, vals: torch.Tensor, size: int,
                             *, round_bf16: bool,
                             perm: torch.Tensor | None = None) -> torch.Tensor:
    if perm is not None:
        vals = vals.index_select(0, perm)
    v = vals.to(torch.bfloat16).float() if round_bf16 else vals
    return vals.new_zeros((size, vals.shape[1])).index_add_(0, si, v)


_SEGMENT_MIN_ROWS = 32     # as MIN_ROWS in csrc/sorted_segment_sum.cu
_SEGMENT_MAX_COLS = 256    # columns a launch takes (its THREADS)


def sorted_segment_sum(si: torch.Tensor, vals: torch.Tensor, size: int, *,
                       round_bf16: bool,
                       perm: torch.Tensor | None = None) -> torch.Tensor:
    """out[s] = sum of r(vals[p(i)]) over i with si[i] == s, in f32: si [M]
    int32 sorted ascending -> [size, F] f32; r rounds to bf16 (round_bf16)
    or is the identity. p(i) = i and vals [M, F] f32, or, given perm [M]
    int32/int64 (a sort permutation, each index in [0, V)), p(i) = perm[i]
    into vals [V, F] f32: the sum of gather_rows(vals, perm) without the
    gathered copy, in one launch, its sums equal to that pair's bit for
    bit. Every slot is written (empty ones with 0). On the card the sums
    run in a fixed order, so two calls on the same input agree bit for bit,
    and keys outside [0, size) are dropped; the plain version takes keys in
    [0, size) only."""
    dev = _check_segment(si, vals, size, perm)
    if not vals.is_cuda:
        return sorted_segment_sum_plain(si, vals, size, round_bf16=round_bf16,
                                        perm=perm)
    m, nf = si.shape[0], vals.shape[1]
    out = vals.new_empty((size, nf))
    if size:
        # two words a column and tile, and room to align them
        state, cap = scan_state(dev, m // _SEGMENT_MIN_ROWS + 2,
                                2 * min(nf, _SEGMENT_MAX_COLS))
        launch("sorted_segment_sum",
               lib("sorted_segment_sum").naruto_sorted_segment_sum, dev,
               si.data_ptr(), vals.data_ptr(),
               None if perm is None else perm.data_ptr(), out.data_ptr(),
               state.data_ptr(), cap, state.numel(), m, vals.shape[0], size,
               nf, int(round_bf16),
               int(perm is not None and perm.dtype == torch.int64))
    return out


# ---------------------------------------------------------------- row scan
_SCAN_TILE = 8192    # as TILE in csrc/row_cumsum.cu


def _check_cumsum(x: torch.Tensor) -> torch.device:
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
    """Inclusive cumsum over the rows of [M, F] f32 (any M, F <= 256), in
    one launch; the sums run in a fixed order, so two calls on the same
    input agree bit for bit."""
    dev = _check_cumsum(x)
    if not x.is_cuda:
        return row_cumsum_plain(x)
    m, nf = x.shape
    out = torch.empty_like(x)
    if m:
        rows = max(4, (_SCAN_TILE // nf) & ~3)
        state, cap = scan_state(dev, -(-m // rows), nf)
        launch("row_cumsum", lib("row_cumsum").naruto_row_cumsum, dev,
               x.data_ptr(), out.data_ptr(), state.data_ptr(), cap,
               state.numel(), m, nf)
    return out
