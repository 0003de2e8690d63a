"""Dense segment sums by sort (counterpart of naruto_tpu/ops/segment.py,
the parts the mapper's backward calls).

``dense_segment_sum_outer_level_major_frac`` is the hash-grid backward: the
rank-1 updates outer(corner weights, level cotangent) are sorted by table
slot (the weights travel as one packed-frac column and are rebuilt after the
sort); the fused scan of ``ops/kernels.py`` writes, for every slot, the
prefix sum through the slot's last update, and an adjacent difference turns
those into per-slot sums.

``dense_segment_sum`` (the uncertainty grid's trilinear VJP) sorts the keys,
gathers the value rows by the sort permutation and sums each run of equal
keys directly with ``primitives.sorted_segment_sum``: no prefix sum, no rank
search, no difference of running totals. It has the JAX function's
signature and default: the values are rounded to bf16 before the f32 sums
unless ``pack_bf16=False`` (the exact form the trilinear VJP uses).

Every row gather here is ``primitives.gather_rows``: like the segment sum, a
kernel on the card and its plain version on the CPU. Each index is in range
by construction (a sort permutation), so the gather's device-side assert
guards it without a host check.
"""
from __future__ import annotations

import torch

from naruto_tpu_torch.ops import kernels, primitives

INT32_MAX = 2 ** 31 - 1
PACK_FRAC_BITS = 10   # 3 axes x 10-bit fixed point in one int32 sort column


def _check_even(ka: int, kb: int) -> None:
    if ka % 2 or kb % 2:
        raise ValueError(f"dense_segment_sum_outer needs even factor widths; "
                         f"got a:{ka} b:{kb}")


def pack_frac(frac: torch.Tensor) -> torch.Tensor:
    """Quantize fractional coords [..., 3] in [0, 1] to 3x10-bit fixed point
    packed in one int32."""
    scale = float((1 << PACK_FRAC_BITS) - 1)
    q = torch.clamp(torch.round(frac * scale), 0, scale).to(torch.int32)
    return q[..., 0] | (q[..., 1] << PACK_FRAC_BITS) \
        | (q[..., 2] << (2 * PACK_FRAC_BITS))


def corner_weights_from_packed(qf: torch.Tensor) -> torch.Tensor:
    """Packed frac [M] int32 -> trilinear corner weights [M, 8] f32 in the
    encoding's corner order."""
    from naruto_tpu_torch.ops.encoding import _corner_weights

    mask = (1 << PACK_FRAC_BITS) - 1
    f = torch.stack([(qf >> (ax * PACK_FRAC_BITS)) & mask for ax in range(3)],
                    dim=-1).to(torch.float32) / float(mask)
    return _corner_weights(f[:, None, :]).reshape(-1, 8)


def _level_major(x2d: torch.Tensor, n_levels: int) -> torch.Tensor:
    """[N, L*K] -> [L*N, K], level-major rows."""
    n = x2d.shape[0]
    return x2d.reshape(n, n_levels, -1).transpose(0, 1).reshape(
        n_levels * n, -1)


def dense_segment_sum_outer_level_major_frac(
        idx_nl: torch.Tensor, frac_nl: torch.Tensor, b_nl: torch.Tensor,
        size: int) -> torch.Tensor:
    """out[s] = sum over (point, level) with idx == s of
    outer(corner_weights(frac), b_level), flattened to [size, 8*B].

    idx_nl: [N, L] slot ids; frac_nl: [N, L, 3] in [0, 1]; b_nl: [N, L*B].
    The flattened M = N*L rows are padded to a multiple of 512 BEFORE the
    sort with INT32_MAX keys and zero payloads: the pads sort to the tail,
    never count as a slot (every slot t < size < INT32_MAX) and add 0."""
    n, L = idx_nl.shape
    kb = b_nl.shape[-1] // L
    _check_even(8, kb)
    dev = idx_nl.device
    pad = (-(n * L)) % kernels.SUB
    key = torch.cat([idx_nl.to(torch.int32).t().reshape(-1),
                     torch.full((pad,), INT32_MAX, dtype=torch.int32,
                                device=dev)])
    qf = torch.cat([pack_frac(frac_nl).t().reshape(-1),
                    torch.zeros((pad,), dtype=torch.int32, device=dev)])
    b16 = torch.cat([_level_major(b_nl.to(torch.bfloat16), L),
                     torch.zeros((pad, kb), dtype=torch.bfloat16,
                                 device=dev)])
    si, perm = torch.sort(key, stable=True)
    sqf = primitives.gather_rows(qf[:, None], perm).reshape(-1)
    sa16 = corner_weights_from_packed(sqf).to(torch.bfloat16)
    sb16 = primitives.gather_rows(b16, perm)
    return _outer_from_sorted(si, sa16, sb16, size)


def _outer_from_sorted(si: torch.Tensor, sa16: torch.Tensor,
                       sb16: torch.Tensor, size: int) -> torch.Tensor:
    """Post-sort tail: hi[t] = total of all entries with key <= t (the
    fused scan's slot rows); per-slot sums are adjacent differences. M must
    already be a multiple of 512."""
    hi = kernels.outer_cumsum_slots(si, sa16.contiguous(), sb16.contiguous(),
                                    size)
    return hi - torch.cat([hi.new_zeros((1, hi.shape[1])), hi[:-1]])


def dense_segment_sum(indices: torch.Tensor, values: torch.Tensor,
                      size: int, pack_bf16: bool = True) -> torch.Tensor:
    """indices [M] in [0, size), values [M, F] -> [size, F] with
    out[s] = sum of values where indices == s.

    pack_bf16 (and an even F): each value is rounded to bf16 before the f32
    sums, as the JAX function's bf16-pair sort payload rounds it;
    pack_bf16=False sums the values exactly in f32. Each slot's sum is taken
    directly over its run of the sorted rows (the JAX function differences a
    prefix sum, which also carries the running total's rounding)."""
    if pack_bf16 and values.shape[1] % 2 == 0:
        values = values.to(torch.bfloat16).to(values.dtype)
    si, perm = torch.sort(indices.to(torch.int32), stable=True)
    sv = primitives.gather_rows(values.contiguous(), perm)
    return primitives.sorted_segment_sum(si, sv, size, round_bf16=False)
