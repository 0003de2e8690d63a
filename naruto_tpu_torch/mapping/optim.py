"""The mapper's optimizers, with each step's bias corrections handed in as
device scalars (counterpart of the optax transforms and ``EmbedAdam`` of
naruto_tpu/mapping/mapper.py).

Adam's bias corrections follow the step count, which lives on the host.
A BA call captured as a CUDA graph (mapping/ba_graph.py) replays the same
kernels with the same arguments every time, so a correction passed as a
Python float would be frozen at its capture-time value. Each optimizer
therefore splits its step in two:

  * ``scalars(count)`` computes the corrections of step ``count`` on the
    host, in float64, exactly as ``torch.optim.Adam`` and the JAX
    package's ``EmbedAdam`` compute them; the caller writes them, rounded
    to float32, into a device tensor (one row per iteration of a call);
  * ``step(..., scalars)`` applies the update with those device scalars.

A kernel takes a Python scalar in float32, so ``x * s`` or ``x / s`` with
``s`` a float32 device scalar gives the bits of the same op on
``float(s)``: ``EmbedAdam`` keeps its arithmetic bit for bit. ``Adam``
runs the foreach ops of ``torch.optim.Adam``'s update in their order. Its
last op, ``_foreach_addcdiv_(params, exp_avg, denom, step_sizes)``, takes
its factors as Python numbers only, so it is written out, as each device's
kernel computes it: on the CPU ``param + (step_size * m) / denom``, on a
card ``param + step_size * (m / denom)`` with the product and the sum
rounded once (nvcc fuses them; ``fused_add_``). Both then equal torch's
Adam bit for bit (tests/test_torch_ba_graph.py on the CPU,
tests/test_torch_cuda.py on the card).

On a card each ``step`` is one launch of a hand-written kernel over all of
the optimizer's leaves (``csrc/adam.cu``: ``embed_adam``, ``adam``), which
rounds every op as the chain above does on the card and reads the
corrections through their device pointers; the eager and the captured BA
calls both take it, and equal each other. The chain stays as each
optimizer's ``step_plain``: the CPU runs it, and the card tests hold the
kernels against it bit for bit.

Counts are advanced by the caller (``count += n``) after a call: a capture
must not advance host state that its replays do not.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from naruto_tpu_torch.ops import kernels

EMBED_B1, EMBED_B2, EMBED_EPS = 0.9, 0.99, 1e-15


class EmbedAdam:
    """Adam for the hash table: betas (0.9, 0.99), eps 1e-15, fp32 master,
    updated in place; the step's corrections 1 / (1 - b^t) as device
    scalars."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @staticmethod
    def scalars(count: int) -> Tuple[float, float]:
        return (1.0 / (1.0 - EMBED_B1 ** count),
                1.0 / (1.0 - EMBED_B2 ** count))

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor], bc1: torch.Tensor,
             bc2: torch.Tensor) -> None:
        if not params[0].is_cuda:
            self.step_plain(params, grads, bc1, bc2)
            return
        _launch_step("embed_adam", kernels.lib("adam").naruto_embed_adam,
                     params, grads, self.mu, self.nu, bc1, bc2, EMBED_B1,
                     1.0 - EMBED_B1, EMBED_B2, 1.0 - EMBED_B2, -self.lr,
                     EMBED_EPS)

    @torch.no_grad()
    def step_plain(self, params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], bc1: torch.Tensor,
                   bc2: torch.Tensor) -> None:
        for p, m, v, g in zip(params, self.mu, self.nu, grads):
            m.mul_(EMBED_B1).add_(g, alpha=1.0 - EMBED_B1)
            v.mul_(EMBED_B2).addcmul_(g, g, value=1.0 - EMBED_B2)
            p.sub_((m * bc1) / (torch.sqrt(v * bc2) + EMBED_EPS),
                   alpha=self.lr)


class Adam:
    """torch.optim.Adam (coupled weight decay, no amsgrad) over fixed
    parameters, its moments allocated once and updated in place; the
    step's sqrt(1 - b2^t) and -lr / (1 - b1^t) as device scalars."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas: Tuple[float, float], eps: float,
                 weight_decay: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.betas, self.eps = lr, betas, eps
        self.weight_decay = weight_decay
        self.count = 0
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]

    def scalars(self, count: int) -> Tuple[float, float]:
        b1, b2 = self.betas
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        return bc2 ** 0.5, (self.lr / bc1) * -1

    @torch.no_grad()
    def reset(self) -> None:
        """Zero the moments (a fresh optimizer; the count is the caller's)."""
        torch._foreach_zero_(self.exp_avg + self.exp_avg_sq)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], bc2_sqrt: torch.Tensor,
             step_size: torch.Tensor) -> None:
        if not self.params[0].is_cuda:
            self.step_plain(grads, bc2_sqrt, step_size)
            return
        b1, b2 = self.betas
        _launch_step("adam", kernels.lib("adam").naruto_adam, self.params,
                     grads, self.exp_avg, self.exp_avg_sq, bc2_sqrt,
                     step_size, self.weight_decay, 1 - b1, b2, 1 - b2,
                     self.eps)

    @torch.no_grad()
    def step_plain(self, grads: Sequence[torch.Tensor],
                   bc2_sqrt: torch.Tensor, step_size: torch.Tensor,
                   card: Optional[bool] = None) -> None:
        """The foreach chain, its last op in the form of the card's kernel
        where `card` (by default where the parameters lie)."""
        if card is None:
            card = self.params[0].is_cuda
        b1, b2 = self.betas
        grads = list(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        torch._foreach_lerp_(self.exp_avg, grads, 1 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1 - b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, bc2_sqrt)
        torch._foreach_add_(denom, self.eps)
        if card:
            # torch's CUDA kernel: param + step_size * (m / denom), the
            # product and the sum rounded once (a fused multiply-add)
            fused_add_(self.params, step_size,
                       torch._foreach_div(self.exp_avg, denom))
        else:
            # torch's CPU kernel: param + (step_size * m) / denom
            update = torch._foreach_mul(self.exp_avg, step_size)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(self.params, update)


def _launch_step(name: str, fn, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 exp_avg: Sequence[torch.Tensor],
                 exp_avg_sq: Sequence[torch.Tensor], s0: torch.Tensor,
                 s1: torch.Tensor, *consts: float) -> None:
    """One launch of csrc/adam.cu's `fn` over every leaf (p, g, m, v), at
    most 16 (the kernel refuses more): each a contiguous float32 tensor of
    its parameter's shape on the parameter's card; s0 and s1 the step's
    two float32 device scalars, read by the kernel when it runs; `consts`
    the optimizer's constants."""
    dev = params[0].device
    if len(grads) != len(params):
        raise ValueError(f"{name}: {len(params)} parameters, {len(grads)} "
                         f"gradients")
    leaves = list(zip(params, grads, exp_avg, exp_avg_sq))
    for quad in leaves:
        for t in quad:
            if t.dtype != torch.float32 or t.device != dev \
                    or not t.is_contiguous() or t.shape != quad[0].shape:
                raise ValueError(
                    f"{name}: every leaf must be a contiguous float32 tensor "
                    f"of its parameter's shape {tuple(quad[0].shape)} on "
                    f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}, "
                    f"contiguous {t.is_contiguous()}")
    for s in (s0, s1):
        if s.dtype != torch.float32 or s.device != dev or s.numel() != 1:
            raise ValueError(f"{name}: the step's scalars must be float32 "
                             f"device scalars on {dev}; got {s.dtype} "
                             f"{tuple(s.shape)} on {s.device}")
    n = len(leaves)
    ptrs = [(ctypes.c_void_p * n)(*[q[j].data_ptr() for q in leaves])
            for j in range(4)]
    numel = (ctypes.c_int64 * n)(*[q[0].numel() for q in leaves])
    kernels.launch(name, fn, dev, *ptrs, numel, n, s0.data_ptr(),
                   s1.data_ptr(), *consts)


def fused_add_(params: Sequence[torch.Tensor], scale: torch.Tensor,
               values: Sequence[torch.Tensor]) -> None:
    """params[i] <- params[i] + scale * values[i] (float32; scale a float32
    scalar tensor) with one rounding, as a fused multiply-add gives it: the
    product of two float32 is exact in float64, their sum is rounded to
    float64 and its error taken exactly (TwoSum); an inexact sum with an
    even last bit moves one float64 step towards the error (round to odd),
    so the one rounding to float32 that follows is the sum's own. All the
    tensors go through one flat buffer: the launches of a call do not grow
    with their count."""
    a = torch.cat([p.reshape(-1) for p in params]).double()
    b = torch.cat([v.reshape(-1) for v in values]).double() * scale.double()
    r = a + b
    t = r - a
    err = (a - (r - t)) + (b - t)
    bits = r.view(torch.int64)
    toward = torch.where((err > 0) == (r > 0), 1, -1)
    bits = bits + torch.where((err != 0) & (bits % 2 == 0), toward, 0)
    out = bits.view(torch.float64).float().split([p.numel() for p in params])
    torch._foreach_copy_(list(params),
                         [o.view_as(p) for o, p in zip(out, params)])
