"""Data-parallel compute: the mapping step's gradient with the ray batch
split across ranks, and the dense volume query with the voxel axis split
(counterpart of naruto_tpu/parallel/sharded.py).

The JAX package annotates shardings and lets XLA insert the all-reduces;
here the collectives are explicit, two per gradient step and one per
volume query, each one ``all_reduce`` (parallel/mesh.py):

  * gradient: each rank renders its rows of the batch (the draws, z-noise
    included, are the full batch's, sliced), the loss's denominators are
    summed over the ranks first (mapping/losses.py, ``group``), so each
    rank's loss is its share of the global one; then every gradient leaf
    and the loss terms go into one flat bucket, summed once. Every rank
    holds the global gradient and steps its optimizers alike, so the
    parameters stay identical across ranks. ``data_parallel_grads`` is
    that step, for Mapper._grad_fn and sharded_grad_step alike.
  * volume: each rank queries its block of pad_to(n, world) / world voxels
    and the blocks are gathered into the full volume on every rank (the
    active-ray selection of every rank reads it). The JAX query leaves its
    output sharded and emits no collective; the host pull (np.asarray)
    gathers it. Here the gather is the one collective, on purpose.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from naruto_tpu_torch.mapping.field import FieldSpec, volume_maps
from naruto_tpu_torch.mapping.losses import LossWeights, total_loss
from naruto_tpu_torch.mapping.render import RenderConfig, render_rays
from naruto_tpu_torch.parallel.mesh import (Mesh, all_reduce, data_sharding,
                                            gather_blocks, pad_to)


def reduce_gradients(grads: Sequence[torch.Tensor], aux: Dict,
                     mesh: Mesh) -> Tuple[List[torch.Tensor], Dict]:
    """Every gradient leaf and every aux scalar summed over the ranks in
    one collective (a flat f32 bucket); each comes back in its own dtype."""
    parts = [g.reshape(-1).float() for g in grads]
    keys = list(aux)
    parts.append(torch.stack([aux[k].float().reshape(()) for k in keys]))
    bucket = all_reduce(torch.cat(parts), "gradients")
    out, i = [], 0
    for g in grads:
        out.append(bucket[i:i + g.numel()].reshape(g.shape).to(g.dtype))
        i += g.numel()
    return out, {k: bucket[i + j] for j, k in enumerate(keys)}


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _like(tree, leaves: List[torch.Tensor]):
    """`tree`'s structure over `leaves` (in tree_leaves' order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def data_parallel_grads(mesh: Optional[Mesh], loss_fn: Callable,
                        wrt: Sequence[torch.Tensor], *rows
                        ) -> Tuple[List[torch.Tensor], Dict]:
    """The gradients of ``loss_fn(*rows, group=mesh)`` -> (loss, aux) with
    respect to `wrt` (zeros where the loss does not reach a leaf) and its
    aux, detached. `rows` are the full batch's per-ray tensors (None passes
    through). With a mesh each rank takes its rows, the loss's
    denominators are the global batch's (losses.total_loss's `group`), and
    gradients and aux are summed over the ranks once: every rank returns
    the whole batch's. Without one, the whole batch on this process."""
    if mesh is not None:
        rows = [None if r is None else data_sharding(mesh, r) for r in rows]
    loss, aux = loss_fn(*rows, group=mesh)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
    aux = {k: v.detach() for k, v in aux.items()}
    if mesh is not None:
        grads, aux = reduce_gradients(grads, aux, mesh)
    return grads, aux


def sharded_grad_step(mesh: Mesh, spec: FieldSpec, rc: RenderConfig,
                      lw: LossWeights):
    """A data-parallel (loss, aux), grads function over the mesh: the ray
    arguments are the full batch on every rank (as the JAX function's
    inputs before their device_put), each rank takes its rows; the
    returned loss, aux and grads (the params tree's structure) are the
    global batch's on every rank. No smoothness term, as the JAX one."""

    def step(params, rays_o, rays_d, target_rgb, target_d, ray_mask,
             z_noise=None):
        def loss_fn(rays_o, rays_d, target_rgb, target_d, ray_mask,
                    z_noise, group):
            rend = render_rays(params, spec, rc, rays_o, rays_d, target_d,
                               z_noise)
            return total_loss(rend, target_rgb, target_d, ray_mask, lw,
                              with_smooth=False, group=group)

        grads, aux = data_parallel_grads(
            mesh, loss_fn, tree_leaves(params), rays_o, rays_d, target_rgb,
            target_d, ray_mask, z_noise)
        return (aux["total"], aux), _like(params, grads)

    return step


def sharded_volume_query(mesh: Mesh, spec: FieldSpec):
    """The dense (sdf, uncert_map) query with the flattened voxel axis split
    across the ranks (padded to a multiple of their number); returns the
    whole volume on every rank."""

    @torch.no_grad()
    def query(params, x01: torch.Tensor):
        n = x01.shape[0]
        per = pad_to(n, mesh.world) // mesh.world
        lo = min(mesh.rank * per, n)
        hi = min(lo + per, n)
        block = torch.zeros((per, 2), dtype=torch.float32, device=x01.device)
        if hi > lo:
            block[:hi - lo] = torch.stack(
                volume_maps(params, x01[lo:hi], spec), -1)
        full = gather_blocks(block, n, mesh, "volumes")
        return full[:, 0], full[:, 1]

    return query
