"""The process group of a data-parallel run (counterpart of
naruto_tpu/parallel/mesh.py).

One process per rank, SPMD: every rank runs the same loop with the same
seed, the ray and voxel axes are split across ranks and the field's
parameters are replicated. The launcher (``torchrun``) gives each process
WORLD_SIZE, RANK and LOCAL_RANK; nothing else is read.

  * the rank's device: ``cuda:LOCAL_RANK`` when every rank has a card of
    its own, else ``cuda:0`` (ranks share the card); the CPU only when the
    caller asks for it;
  * the backend, by ``choose_backend``: NCCL when every rank has a card of
    its own, Gloo on the CPU and where ranks share a card (NCCL refuses
    two ranks on one device);
  * every collective of the port is one ``all_reduce`` (sum) through
    ``all_reduce`` here, which counts it in ``COLLECTIVES`` by site, in the
    manner of ops/kernels.py's LAUNCHES. A gather is an all-reduce of a
    zero-filled full buffer in which each rank writes its own rows: adding
    zeros is exact, and one code path serves both backends. Within
    ``timed_collectives`` each is also timed alone, by site.

``make_mesh`` joins (or reuses) the process group; ``data_sharding`` and
``replicated`` give a rank's part of a full tensor, as the JAX package's
two NamedShardings place it: its rows of the first axis, or all of it.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

# collectives since the last reset, by the site that makes them: the
# loss denominators and the gradient bucket of a sharded BA iteration,
# the gather of a sharded volume query, the end-of-run replica check
COLLECTIVES = {"denominators": 0, "gradients": 0, "volumes": 0,
               "checksum": 0}
# how long a rank waits in a collective for a peer before it fails
TIMEOUT = datetime.timedelta(minutes=5)
# seconds spent in collectives by site, while timed_collectives() is on
_SECONDS: Optional[dict] = None


def reset_collective_counts() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def collective_counts() -> dict:
    return dict(COLLECTIVES)


class Mesh(NamedTuple):
    """The ranks of the 'data' axis: this process's rank, their number, the
    torch device this rank computes on and the backend of the group."""
    world: int
    rank: int
    device: torch.device
    backend: str

    def describe(self) -> str:
        share = ("ranks share a card" if self.backend == "gloo"
                 and self.device.type == "cuda" else
                 "a card per rank" if self.device.type == "cuda"
                 else "host")
        return (f"[parallel] {self.world} ranks, backend {self.backend} "
                f"({share}); rank {self.rank} on {self.device}")


def launcher_env() -> tuple:
    """(world, rank, local_rank) from the launcher's environment; (1, 0, 0)
    outside a launcher."""
    env = os.environ
    return (int(env.get("WORLD_SIZE", 1)), int(env.get("RANK", 0)),
            int(env.get("LOCAL_RANK", 0)))


def choose_backend(device_type: str, world: int, n_cards: int) -> str:
    """NCCL when every rank has a card of its own, else Gloo (the CPU, or
    ranks that share a card)."""
    if device_type == "cuda" and world <= n_cards:
        return "nccl"
    return "gloo"


def rank_device(device: str, world: int, local_rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA rank needs a CUDA device and none is "
                           "available; pass device='cpu' to run on the "
                           "host")
    n = torch.cuda.device_count()
    return torch.device("cuda", local_rank if world <= n else 0)


def make_mesh(device: str = "cuda",
              init_method: Optional[str] = None) -> Optional[Mesh]:
    """The data-parallel mesh of this process: joins the process group of
    the launcher's WORLD_SIZE ranks (``init_method``, default the
    launcher's env://; a ``file://`` path where no port may be taken), or
    reuses the group already joined. None with one rank."""
    world, rank, local_rank = launcher_env()
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    if world <= 1:
        return None
    dev = rank_device(device, world, local_rank)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, world, n_cards)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world, rank=rank, timeout=TIMEOUT)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}; "
                           f"ranks on {dev} need {backend}")
    return Mesh(world, rank, dev, backend)


def current_mesh(device) -> Optional[Mesh]:
    """The mesh of the process group already joined, for a module on
    `device`; None without one (or with one rank)."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.get_world_size(), dist.get_rank(), dev,
                dist.get_backend())


def shard_slice(n: int, world: int, rank: int) -> slice:
    """The rank's rows of an axis of n rows, n a multiple of world."""
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def pad_to(n: int, world: int) -> int:
    """n rounded up to a multiple of world (the voxel axis is padded so
    that every rank takes as many rows)."""
    return -(-n // world) * world


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed_collectives():
    """Within it, each collective waits for the work queued before it,
    then for its own end, and adds that wall to the dict it yields, by
    site: what a site costs alone, without the overlap the waits remove."""
    global _SECONDS
    _SECONDS = {k: 0.0 for k in COLLECTIVES}
    try:
        yield _SECONDS
    finally:
        _SECONDS = None


def all_reduce(t: torch.Tensor, site: str) -> torch.Tensor:
    """Sum `t` over the ranks in place (one collective, counted at
    `site`); returns t."""
    COLLECTIVES[site] += 1
    if _SECONDS is None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t
    _sync(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    _sync(t.device)
    _SECONDS[site] += time.perf_counter() - t0
    return t


def gather_blocks(local: torch.Tensor, n: int, mesh: Mesh,
                site: str) -> torch.Tensor:
    """All ranks' rows of an axis split by pad_to(n, world) / world rows a
    rank, the padding dropped: `local` [per, ...] is this rank's block.
    One all-reduce of a zero-filled full buffer."""
    per = local.shape[0]
    full = torch.zeros((per * mesh.world,) + tuple(local.shape[1:]),
                       dtype=local.dtype, device=local.device)
    full[mesh.rank * per:(mesh.rank + 1) * per] = local
    return all_reduce(full, site)[:n]


def data_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of x's first axis (ray and voxel batches)."""
    return x[shard_slice(x.shape[0], mesh.world, mesh.rank)]


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """All of x on every rank (the field's parameters)."""
    return x


def _checksum(t: torch.Tensor) -> torch.Tensor:
    """An int64 checksum of t's f32 bits, sensitive to their order."""
    bits = t.detach().to(torch.float32).contiguous().reshape(-1).view(
        torch.int32).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
    return torch.sum(bits * w)


def assert_replicated(mesh: Mesh, tensors, what: str) -> None:
    """Raise unless every rank holds the same bits in `tensors` (one
    collective: each rank writes its checksums in its row of a zero
    table)."""
    sums = torch.stack([_checksum(torch.as_tensor(t, device=mesh.device))
                        for t in tensors])
    table = torch.zeros((mesh.world, sums.numel()), dtype=torch.int64,
                        device=mesh.device)
    table[mesh.rank] = sums
    all_reduce(table, "checksum")
    differ = (table != table[0]).any(dim=1).nonzero().reshape(-1).tolist()
    if differ:
        raise RuntimeError(f"{what} differ across ranks: ranks {differ} "
                           f"against rank 0")
