"""The neural mapper: first-frame mapping, tracking, global bundle
adjustment (BA) and the dense SDF/uncertainty volumes (counterpart of
naruto_tpu/mapping/mapper.py).

  * first-frame mapping: ``first_iters`` iterations of (sample pixels ->
    render -> loss -> Adam) on frame 0; the uncertainty grid's gradients
    accumulate over all of them and are applied once at the end.
  * global BA: ``iters`` iterations of {sample keyframe-DB rays plus
    current-frame rays, keep ``sample`` + cur_cap/4 of them by active-ray
    uncertainty selection, render, losses, backward, Adam on the hash table
    (eps 1e-15) and the decoders (coupled weight decay 1e-6), and every
    ``uncert_accum_iters`` iterations on the uncertainty grid with the
    accumulated gradients}. With tracking on, the keyframe poses (but the
    first) and the current pose are optimised too, as axis-angle and
    translation with their own Adam (betas (0.9, 0.99), eps 1e-8),
    stepped every ``pose_accum_step`` iterations on the accumulated
    gradients, and written back after the step.
  * tracking (``mapper.tracking_enable``): from the constant-speed
    initialisation, ``track_iter`` Adam steps on the current pose alone
    against the frozen field, on ``track_sample`` pixels away from the
    border; the lowest-loss iterate is kept (``track_best``).
  * volumes: the field's SDF and uncertainty on the planner's voxel grid,
    uncertainty zeroed off-surface.

The JAX ``lax.scan`` is a Python loop and its ``lax.cond``s are Python
``if``s on the host-side iteration number. Every random draw is an
argument: ``BADraws`` / ``FirstFrameDraws`` / ``TrackDraws`` per iteration
and one U[0, 1) score per pixel for a keyframe insertion; in a run they come from one
``torch.Generator`` per draw site (utils/seeding.py), in the tests from
replayed JAX key splits. The current-frame ray block is padded to one of
``CUR_BUCKETS`` and masked, as in the JAX package.

Meshes (``save_mesh``, the periodic snapshot of ``online_recon_step``) and
evaluation checkpoints (``save_ckpt`` / ``load_ckpt``, in the JAX package's
npz format) are as in the JAX package. With a ``Timer`` the online step
times its stages as [Mapper] sections; like the JAX package's, a section
around device work ends when the work is enqueued.

Volumes: a mapping step hands back a ``LazyVolumes`` view, whose host copy
is made only when a consumer reads it (timed as ``volumes_wait``), and the
next BA first waits for the previous step's volumes on the device
(``ba_drain``): one mapping step in flight at most.

Full state (``save_full_state`` / ``load_full_state``): the JAX package's
``MapperState`` tree in its npz format, either package's file loading in
the other, with the draw sites' generator states in the header.

Data-parallel (parallel/, under a process group of several ranks): with
``parallel.shard_rays`` and tracking off, ``_grad_fn`` splits each batch
of rays over the ranks (every rank draws the full batch and takes its
rows, so the draws are the unsharded run's), sums the loss denominators
and then the gradients over the ranks, and every rank takes the same Adam
steps; a batch whose ray count is not a multiple of the ranks' runs
unsharded. With ``parallel.shard_volumes`` the volume query splits the
voxel axis and gathers the whole volume on every rank.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from naruto_tpu_torch.config import MainConfig
from naruto_tpu_torch.geometry.rays import get_camera_rays
from naruto_tpu_torch.geometry.voxel import volume_shape, world_grid
from naruto_tpu_torch.mapping.field import (FieldSpec, init_field_params,
                                            query_sdf, volume_maps)
from naruto_tpu_torch.mapping.keyframes import (KeyframeDB, add_keyframe,
                                                sample_global_rays)
from naruto_tpu_torch.mapping.losses import (LossWeights, smoothness_points,
                                             total_loss)
from naruto_tpu_torch.mapping.pose_opt import (const_speed_init,
                                               matrix_from_tensor,
                                               pose_to_tensor)
from naruto_tpu_torch.mapping.render import RenderConfig, render_rays
from naruto_tpu_torch.ops.encoding import table_leaves
from naruto_tpu_torch.ops.mlp import use_full_fp32_matmul
from naruto_tpu_torch.parallel.mesh import current_mesh
from naruto_tpu_torch.parallel.sharded import (data_parallel_grads,
                                               sharded_volume_query)
from naruto_tpu_torch.sim.base import quantize_color
from naruto_tpu_torch.utils import ckpt_io
from naruto_tpu_torch.utils.printer import InfoPrinter
from naruto_tpu_torch.utils.seeding import (generator_states,
                                            make_generators,
                                            set_generator_states)
from naruto_tpu_torch.utils.timer import Timer

# padded current-ray block sizes, as in the JAX package
CUR_BUCKETS = (512, 2048, 8192)

EMBED_B1, EMBED_B2, EMBED_EPS = 0.9, 0.99, 1e-15
# the full-state header's key of the port's generator states (the JAX
# package keeps its threefry key under "rng_key", which the port never
# writes)
GENERATORS_KEY = "torch_generator_states"
# the pose Adam (optax.adam's defaults but b2): rotation and translation
# groups with their own learning rates
POSE_BETAS, POSE_EPS = (0.9, 0.99), 1e-8


class LazyVolumes:
    """(uncert_vol, sdf_vol) of one mapping step. Indexing and iteration
    give the device tensors (the planner's aggregation reads them there);
    ``host(i)`` gives volume i as host numpy, copied on its first read into
    pinned memory on a side stream behind the event recorded when the
    volumes were enqueued, and timed as [Mapper] ``volumes_wait``. A step
    whose consumers never read a host copy never waits for the device, and
    a volume no one reads on the host is never copied. ``ready()`` waits
    for the volumes on the device, no copy. The values are those of an
    eager pull."""

    def __init__(self, u: torch.Tensor, s: torch.Tensor,
                 timer: Optional[Timer] = None, stream=None):
        self._dev = (u, s)
        self._np: List[Optional[np.ndarray]] = [None, None]
        self._timer = timer
        self._event = None
        if u.is_cuda:
            self._stream = stream or torch.cuda.Stream(u.device)
            self._event = torch.cuda.Event()
            self._event.record()

    def ready(self) -> "LazyVolumes":
        if self._event is not None:
            self._event.synchronize()
        return self

    def _pull(self, t: torch.Tensor) -> np.ndarray:
        if self._event is None:
            return t.cpu().numpy()
        stream = self._stream
        stream.wait_event(self._event)
        with torch.cuda.stream(stream):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            # the copy reads t on the side stream: keep its memory from
            # reuse until the copy is done
            t.record_stream(stream)
            done = torch.cuda.Event()
            done.record(stream)
        done.synchronize()
        return host.numpy()

    def host(self, i: int) -> np.ndarray:
        if self._np[i] is None:
            with (self._timer.time("volumes_wait", "Mapper") if self._timer
                  else contextlib.nullcontext()):
                self._np[i] = self._pull(self._dev[i])
        return self._np[i]

    def __getitem__(self, i: int) -> torch.Tensor:
        return self._dev[i]

    def __iter__(self):
        return iter(self._dev)

    def __len__(self) -> int:
        return 2


class FirstFrameDraws(NamedTuple):
    idx: torch.Tensor           # [sample] pixel indices in [0, H*W)
    z_noise: torch.Tensor       # [sample, S] U[0, 1)
    importance_u: Optional[torch.Tensor] = None   # [sample, n_importance]


class BADraws(NamedTuple):
    g_idx: torch.Tensor         # [n_os] keyframe-DB ray indices
    cur_j: torch.Tensor         # [cur_cap] picks among valid current pixels
    z_noise: torch.Tensor       # [n_rays, S] U[0, 1)
    smooth_offset: torch.Tensor  # [3] U[0, 1) lattice offset
    smooth_jitter: torch.Tensor  # [3] U[0, 1) lattice jitter
    importance_u: Optional[torch.Tensor] = None   # [n_rays, n_importance]
    smooth_base: Optional[torch.Tensor] = None    # [3, S, 3] pair bases
    smooth_diffc: Optional[torch.Tensor] = None   # [3, S, 1] their axis


class TrackDraws(NamedTuple):
    us: torch.Tensor            # [track_sample] pixel columns
    vs: torch.Tensor            # [track_sample] pixel rows
    z_noise: torch.Tensor       # [track_sample, S] U[0, 1)
    importance_u: Optional[torch.Tensor] = None   # [track_sample, n_imp]


def _pose_adam(rot: List[torch.Tensor], trans: List[torch.Tensor],
               lr_rot: float, lr_trans: float) -> torch.optim.Adam:
    return torch.optim.Adam([{"params": rot, "lr": lr_rot},
                             {"params": trans, "lr": lr_trans}],
                            betas=POSE_BETAS, eps=POSE_EPS)


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


class BAPoses:
    """The pose variables of one BA step with pose optimisation: every
    keyframe slot's axis-angle and translation (slot 0 and the empty slots
    masked: they keep their poses) and the current frame's, their Adam,
    and the gradients accumulated since its last step."""

    def __init__(self, poses: torch.Tensor, c2w: torch.Tensor, num_kf: int,
                 kf_count: int, m):
        dev = poses.device
        self.ids = torch.arange(num_kf, device=dev) * m.keyframe_every
        # slots past the pose table read its last row, as JAX's clamped
        # gather does; they are masked and never written back
        self.fixed = poses[torch.clamp(self.ids, max=poses.shape[0] - 1)]
        slot = torch.arange(num_kf, device=dev)
        self.slot_mask = ((slot > 0) & (slot < kf_count)).to(
            torch.float32)[:, None]
        self.c2w, self.optim_cur = c2w, m.optim_cur
        self.rot, self.trans = map(_leaf, pose_to_tensor(self.fixed))
        self.rot_c, self.trans_c = map(_leaf, pose_to_tensor(c2w))
        self.leaves = [self.rot, self.trans, self.rot_c, self.trans_c]
        self.opt = _pose_adam([self.rot, self.rot_c],
                              [self.trans, self.trans_c], m.lr_rot,
                              m.lr_trans)
        self.accum = [torch.zeros_like(t) for t in self.leaves]

    def kf_matrices(self) -> torch.Tensor:
        mats = matrix_from_tensor(self.rot, self.trans)
        return torch.where(self.slot_mask[..., None] > 0, mats, self.fixed)

    def cur_matrix(self) -> torch.Tensor:
        if self.optim_cur:
            return matrix_from_tensor(self.rot_c[None], self.trans_c[None])[0]
        return self.c2w

    @torch.no_grad()
    def accumulate(self, grads: Sequence[torch.Tensor]) -> None:
        for a, g, mask in zip(self.accum, grads,
                              (self.slot_mask, self.slot_mask, 1.0, 1.0)):
            a += g * mask

    @torch.no_grad()
    def step(self) -> None:
        for p, a in zip(self.leaves, self.accum):
            p.grad = a.clone()
            a.zero_()
        self.opt.step()
        for p in self.leaves:
            p.grad = None

    @torch.no_grad()
    def write_back(self, poses: torch.Tensor, frame_id: int) -> None:
        keep = self.ids < poses.shape[0]
        poses[self.ids[keep]] = self.kf_matrices()[keep]
        if self.optim_cur:
            poses[frame_id] = self.cur_matrix()


class BASetup(NamedTuple):
    """Per-mapping-step invariants of the BA iterations."""
    cur_cap: int
    frame_rays: torch.Tensor
    c2w: torch.Tensor
    valid_order: torch.Tensor   # valid current pixels first (stable)
    n_valid: int
    num_cur: int
    pose: Optional[BAPoses] = None   # with tracking on


class EmbedAdam:
    """Adam for the hash table: betas (0.9, 0.99), eps 1e-15, fp32 master,
    updated in place."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor],
             grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        bc1 = 1.0 / (1.0 - EMBED_B1 ** self.count)
        bc2 = 1.0 / (1.0 - EMBED_B2 ** self.count)
        for p, m, v, g in zip(params, self.mu, self.nu, grads):
            m.mul_(EMBED_B1).add_(g, alpha=1.0 - EMBED_B1)
            v.mul_(EMBED_B2).addcmul_(g, g, value=1.0 - EMBED_B2)
            p.sub_((m * bc1) / (torch.sqrt(v * bc2) + EMBED_EPS),
                   alpha=self.lr)


def field_spec_from_config(cfg: MainConfig) -> FieldSpec:
    m = cfg.mapper
    return FieldSpec(
        bound=tuple(tuple(b) for b in m.bound),
        n_levels=cfg.grid.n_levels,
        n_features=cfg.grid.n_features_per_level,
        log2_hashmap_size=cfg.grid.hash_size,
        base_resolution=cfg.grid.base_resolution,
        table_dtype=cfg.grid.table_dtype,
        table_layout=cfg.grid.layout,
        sort_carry=cfg.grid.sort_carry,
        voxel_sdf=cfg.grid.voxel_sdf,
        pos_n_bins=cfg.grid.pos_n_bins,
        geo_feat_dim=cfg.decoder.geo_feat_dim,
        hidden_dim=cfg.decoder.hidden_dim,
        num_layers=cfg.decoder.num_layers,
        hidden_dim_color=cfg.decoder.hidden_dim_color,
        num_layers_color=cfg.decoder.num_layers_color,
        uncert_grid=cfg.decoder.uncert_grid,
        pred_uncert=cfg.decoder.pred_uncert,
        uncert_voxel_size=m.voxel_size,
        diff_positions=m.tracking_enable,
    )


def _like_table(table, leaves: Sequence):
    """The table's tree shape ({"hash", "dense"} or one tensor) over
    `leaves` given in table_leaves order."""
    if isinstance(table, dict):
        return {"hash": leaves[0], "dense": list(leaves[1:])}
    return leaves[0]


def _i32(n) -> np.ndarray:
    return np.asarray(int(n), np.int32)


def _adam_state(opt: Optional[torch.optim.Adam], params: Sequence):
    """(count, exp_avg list, exp_avg_sq list) of a torch Adam over
    `params` (zeros before its first step, and for no optimizer)."""
    st = [opt.state.get(p, {}) if opt is not None else {} for p in params]
    count = int(st[0]["step"]) if st and st[0] else 0
    mu = [x["exp_avg"] if x else torch.zeros_like(p)
          for x, p in zip(st, params)]
    nu = [x["exp_avg_sq"] if x else torch.zeros_like(p)
          for x, p in zip(st, params)]
    return count, mu, nu


@torch.no_grad()
def _set_adam_state(opt: torch.optim.Adam, params: Sequence, count: int,
                    mu: Sequence, nu: Sequence) -> None:
    for p, m, v in zip(params, mu, nu):
        opt.state.pop(p, None)
        if count > 0:
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(m)).to(p.device),
                "exp_avg_sq": torch.from_numpy(np.array(v)).to(p.device)}


def _copy_into(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"snapshot leaf shape {tuple(src.shape)} != "
                         f"configured {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(src.astype(np.float32, copy=False)
                               if dst.is_floating_point() else src))


def _param_groups(params) -> Dict[str, List[torch.Tensor]]:
    """The optimiser groups: hash table, decoders, uncertainty grid."""
    return {"table": table_leaves(params["table"]),
            "decoder": [*params["sdf_mlp"], *params["color_mlp"]],
            "uncert": ([params["uncert_grid"]] if "uncert_grid" in params
                       else [])}


def _detached(tree):
    """The params tree with every tensor cut from the graph (a frozen field:
    no gradient reaches, or is computed for, its tensors)."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_detached(v) for v in tree]
    return tree.detach()


def _transform_rays(rays: torch.Tensor, poses: torch.Tensor):
    """rays [N, 7] camera frame, poses [N, 4, 4] -> world
    (rays_o, rays_d, rgb, depth)."""
    rays_d = torch.einsum("nij,nj->ni", poses[:, :3, :3], rays[:, :3])
    return poses[:, :3, 3], rays_d, rays[:, 3:6], rays[:, 6:7]


class Mapper:
    """Host-facing mapper with the reference's online API
    (online_recon_step / predict_sdf) on one torch device."""

    def __init__(self, cfg: MainConfig, device="cuda",
                 printer: Optional[InfoPrinter] = None,
                 timer: Optional[Timer] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Mapper(device='cuda') needs a CUDA device "
                               "and none is available")
        use_full_fp32_matmul()
        self.cfg = cfg
        self.printer = printer or InfoPrinter(quiet=True)
        # records a per-stage breakdown of online_recon_step when given
        self.timer = timer
        # where save_mesh writes (the engine sets the run's directory)
        self.result_dir: Optional[str] = None
        m, t, c = cfg.mapper, cfg.training, cfg.cam
        self.track_enabled = m.tracking_enable
        dev = self.device

        self.spec = field_spec_from_config(cfg)
        self.rc = RenderConfig(
            near=c.near, far=c.far, n_range_d=t.n_range_d, range_d=t.range_d,
            n_samples_d=t.n_samples_d, n_importance=t.n_importance,
            perturb=t.perturb, trunc=t.trunc, sc_factor=t.sc_factor)
        self.lw = LossWeights(
            rgb=t.rgb_weight, depth=t.depth_weight, sdf=t.sdf_weight,
            fs=t.fs_weight, uncert=t.uncert_weight, smooth=t.smooth_weight,
            rgb_missing=t.rgb_missing, trunc=t.trunc, sc_factor=t.sc_factor,
            depth_trunc=c.depth_trunc, smooth_pts=t.smooth_pts,
            smooth_vox=t.smooth_vox, smooth_margin=t.smooth_margin,
            smooth_sample=t.smooth_sample)

        self.H, self.W = c.H // c.downsample, c.W // c.downsample
        self.fx, self.fy = c.fx // c.downsample, c.fy // c.downsample
        self.cx, self.cy = c.cx // c.downsample, c.cy // c.downsample
        self.rays_d_cam = torch.from_numpy(get_camera_rays(
            self.H, self.W, self.fx, self.fy, self.cx, self.cy
        ).reshape(-1, 3)).to(dev)

        num_frames = -(-cfg.general.num_iter // 1000) * 1000
        self.num_kf = -(-(num_frames // m.keyframe_every + 1) // 256) * 256
        self.rays_per_kf = max(int(self.H * self.W * m.n_pixels), 1)

        self.vol_shape = volume_shape(m.bound_np, m.voxel_size)
        grid = world_grid(m.bound_np, m.voxel_size).reshape(-1, 3)
        self.grid01 = torch.from_numpy(
            (grid - m.bound_np[:, 0]) / (m.bound_np[:, 1] - m.bound_np[:, 0])
        ).to(dev)
        self._bound_lo = torch.from_numpy(m.bound_np[:, 0]).to(dev)
        self._vol_max = torch.tensor([s - 1 for s in self.vol_shape],
                                     device=dev)

        self.gens = make_generators(cfg.general.seed, dev)
        self.params = init_field_params(self.spec, self.gens["init"], dev)
        self._groups = _param_groups(self.params)
        for p in self._all_params():
            p.requires_grad_(True)
        self.embed_opt = EmbedAdam(self._groups["table"], m.lr_embed)
        self.decoder_opt = torch.optim.Adam(
            self._groups["decoder"], lr=m.lr_decoder, betas=(0.9, 0.99),
            eps=1e-8, weight_decay=1e-6)
        self.uncert_opt = (torch.optim.Adam(
            self._groups["uncert"], lr=m.lr_uncert, betas=(0.9, 0.99),
            eps=1e-8) if self.spec.uncert_grid else None)
        self.uncert_accum = (torch.zeros_like(self.params["uncert_grid"])
                             if self.spec.uncert_grid else None)

        self.kf = KeyframeDB(self.num_kf, self.rays_per_kf, dev)
        self.poses = torch.eye(4, device=dev).repeat(num_frames + 1, 1, 1)
        self.uncert_vol = torch.zeros(self.vol_shape, device=dev)
        self.step = 0
        # per-iteration losses (device scalars) of the last mapping call
        self.last_aux: List[Dict] = []
        # the last mapping step's volumes, drained before the next BA
        self._pending_vols: Optional[LazyVolumes] = None
        self._copy_stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                             else None)

        # data-parallel BA and volumes over the process group already
        # joined (parallel/mesh.py), as the JAX package's over its devices:
        # the BA shards only with tracking off
        self.mesh = current_mesh(dev)
        par = cfg.parallel
        self._ba_mesh = (self.mesh if par.shard_rays
                         and not self.track_enabled else None)
        self._sharded_vol = (sharded_volume_query(self.mesh, self.spec)
                             if par.shard_volumes and self.mesh is not None
                             else None)

    def _all_params(self) -> List[torch.Tensor]:
        return [p for g in self._groups.values() for p in g]

    def update_step(self, step: int) -> None:
        self.step = step

    # ------------------------------------------------------------- weights
    @torch.no_grad()
    def load_weights(self, tree) -> None:
        """Copy field params from an in-memory pytree of numpy arrays (the
        params tree, or a tree holding it under "params", e.g. the JAX
        package's state) into this mapper. Files go through load_ckpt."""
        if "params" in tree:
            tree = tree["params"]
        self._check_param_compat(tree)
        new_groups = _param_groups(ckpt_io.to_torch(tree, self.device))
        for k, cur in self._groups.items():
            for p, q in zip(cur, new_groups[k]):
                p.copy_(q)

    # ------------------------------------------------------ frame handling
    def frame_to_rays(self, color, depth) -> torch.Tensor:
        """[H, W, 3] colour in [0, 1] (or uint8), [H, W] depth -> [H*W, 7]
        rays on the device. Host float colour is quantized to uint8 as in
        the JAX package; device tensors pass through."""
        if isinstance(color, np.ndarray) and color.dtype != np.uint8:
            color = quantize_color(color)
        color = torch.as_tensor(color, device=self.device)
        if color.dtype == torch.uint8:
            color = color.reshape(-1, 3).to(torch.float32) * (1.0 / 255.0)
        else:
            color = color.to(torch.float32).reshape(-1, 3)
        depth = torch.as_tensor(depth, dtype=torch.float32,
                                device=self.device).reshape(-1, 1)
        return torch.cat([self.rays_d_cam, color, depth], dim=-1)

    # ------------------------------------------------------- loss + update
    def _loss_fn(self, rays_o, rays_d, target_rgb, target_d, ray_mask,
                 z_noise, smooth=None, smooth_scale: float = 1.0,
                 importance_u=None, params=None, group=None):
        """smooth: (offset_u, jitter, base, diffc) lattice draws (the last
        two None unless smooth_sample), or None for no smoothness term this
        iteration. params: the field (this mapper's by default). group: the
        mesh whose ranks each hold a slice of the batch (total_loss)."""
        lw = (self.lw._replace(smooth=self.lw.smooth * smooth_scale)
              if smooth_scale != 1.0 else self.lw)
        with_smooth = smooth is not None
        extra = None
        if with_smooth and lw.smooth > 0:
            extra, _ = smoothness_points(self.spec, lw, *smooth)
        rend = render_rays(self.params if params is None else params,
                           self.spec, self.rc, rays_o, rays_d, target_d,
                           z_noise, extra_pts01=extra,
                           importance_u=importance_u)
        return total_loss(rend, target_rgb, target_d, ray_mask, lw,
                          with_smooth=with_smooth, group=group)

    def _grad_fn(self, rays_o, rays_d, target_rgb, target_d, ray_mask,
                 z_noise, smooth=None, smooth_scale: float = 1.0,
                 importance_u=None, pose_leaves: Sequence = ()):
        """-> (aux, grads by group {"table", "decoder", "uncert"}, and
        "pose" for `pose_leaves` when there are any: zeros where the loss
        does not reach one)).

        With the BA sharded (``_ba_mesh``) and a ray count that the ranks
        split evenly, each rank takes its rows of every per-ray argument,
        the loss's denominators are summed over the ranks, and the
        gradients and aux are summed once (parallel/sharded.py): each
        rank returns the unsharded batch's. Otherwise the whole batch."""
        mesh = self._ba_mesh
        if mesh is not None and rays_o.shape[0] % mesh.world:
            mesh = None

        def loss_fn(rays_o, rays_d, target_rgb, target_d, ray_mask, z_noise,
                    importance_u, group):
            return self._loss_fn(rays_o, rays_d, target_rgb, target_d,
                                 ray_mask, z_noise, smooth, smooth_scale,
                                 importance_u, group=group)

        flat, aux = data_parallel_grads(
            mesh, loss_fn, self._all_params() + list(pose_leaves), rays_o,
            rays_d, target_rgb, target_d, ray_mask, z_noise, importance_u)
        grads, i = {}, 0
        for k, g in self._groups.items():
            grads[k] = list(flat[i:i + len(g)])
            i += len(g)
        if pose_leaves:
            grads["pose"] = flat[i:]
        return aux, grads

    @torch.no_grad()
    def _apply_map_update(self, grads: Dict) -> None:
        for p, g in zip(self._groups["decoder"], grads["decoder"]):
            p.grad = g
        self.decoder_opt.step()
        for p in self._groups["decoder"]:
            p.grad = None
        self.embed_opt.step(self._groups["table"], grads["table"])

    @torch.no_grad()
    def _accum_uncert(self, grads: Dict) -> None:
        if self.spec.uncert_grid:
            self.uncert_accum += grads["uncert"][0]

    @torch.no_grad()
    def _apply_uncert_update(self) -> None:
        if not self.spec.uncert_grid:
            return
        grid = self.params["uncert_grid"]
        grid.grad = self.uncert_accum
        self.uncert_opt.step()
        grid.grad = None
        self.uncert_accum = torch.zeros_like(grid)

    # -------------------------------------------------- first-frame mapping
    def _draw_importance(self, n: int) -> Optional[torch.Tensor]:
        """The importance draws of n rays, or None where the renderer takes
        none (no importance samples, or evenly spaced ones)."""
        rc = self.rc
        if rc.n_importance <= 0 or rc.perturb == 0.0:
            return None
        return torch.rand((n, rc.n_importance), device=self.device,
                          generator=self.gens["importance_u"])

    def _draw_first_frame(self) -> FirstFrameDraws:
        n, dev = self.cfg.mapper.sample, self.device
        return FirstFrameDraws(
            idx=torch.randint(0, self.H * self.W, (n,), device=dev,
                              generator=self.gens["first_frame_rays"]),
            z_noise=torch.rand((n, self.rc.n_samples), device=dev,
                               generator=self.gens["z_noise"]),
            importance_u=self._draw_importance(n))

    def _first_frame_impl(self, frame_rays, c2w,
                          draws: Iterable[FirstFrameDraws]) -> List[Dict]:
        n = self.cfg.mapper.sample
        self.poses[0] = c2w
        pose = c2w.expand(n, 4, 4)
        mask = torch.ones((n,), device=self.device)
        auxes = []
        for d in draws:
            rays_o, rays_d, rgb, dep = _transform_rays(frame_rays[d.idx],
                                                       pose)
            aux, grads = self._grad_fn(rays_o, rays_d, rgb, dep, mask,
                                       d.z_noise, importance_u=d.importance_u)
            self._apply_map_update(grads)
            self._accum_uncert(grads)
            auxes.append(aux)
        self._apply_uncert_update()
        return auxes

    # ------------------------------------------------------------ global BA
    def _n_os(self) -> int:
        m = self.cfg.mapper
        return m.sample * (m.act_ray_oversample_mul if m.active_ray else 1)

    def _min_cur(self) -> int:
        m = self.cfg.mapper
        return m.min_pixels_cur * (m.act_ray_oversample_mul if m.active_ray
                                   else 1)

    def _ba_setup(self, cur_cap: int, frame_rays, c2w,
                  frame_id: int) -> BASetup:
        self.poses[frame_id] = c2w
        depth = frame_rays[:, 6]
        valid = (depth > 0.0) & (depth <= self.lw.depth_trunc)
        n_valid = max(int(valid.sum()), 1)
        valid_order = torch.argsort((~valid).to(torch.uint8), stable=True)
        num_cur = min(max(self._n_os() // max(self.kf.count, 1),
                          self._min_cur()), cur_cap)
        pose = (BAPoses(self.poses, c2w, self.num_kf, self.kf.count,
                        self.cfg.mapper) if self.track_enabled else None)
        return BASetup(cur_cap, frame_rays, c2w, valid_order, n_valid,
                       min(max(num_cur, 0), n_valid), pose)

    def _ba_n_rays(self, cur_cap: int) -> int:
        m = self.cfg.mapper
        if m.active_ray:
            return m.sample + cur_cap // 4
        return self._n_os() + cur_cap

    def _draw_ba(self, setup: BASetup) -> BADraws:
        dev, g = self.device, self.gens
        total = max(self.kf.count * self.kf.rays_per_slot, 1)
        n_rays = self._ba_n_rays(setup.cur_cap)
        s, n = self.lw.smooth_sample, self.lw.smooth_pts - 1
        pairs = {}
        if s:
            pairs = dict(
                smooth_base=torch.randint(0, n, (3, s, 3), device=dev,
                                          generator=g["smooth_pairs"]),
                smooth_diffc=torch.randint(0, n - 1, (3, s, 1), device=dev,
                                           generator=g["smooth_pairs"]))
        return BADraws(
            g_idx=torch.randint(0, total, (self._n_os(),), device=dev,
                                generator=g["global_rays"]),
            cur_j=torch.randint(0, setup.n_valid, (setup.cur_cap,),
                                device=dev, generator=g["current_rays"]),
            z_noise=torch.rand((n_rays, self.rc.n_samples), device=dev,
                               generator=g["z_noise"]),
            smooth_offset=torch.rand((3,), device=dev,
                                     generator=g["smoothness"]),
            smooth_jitter=torch.rand((3,), device=dev,
                                     generator=g["smoothness"]),
            importance_u=self._draw_importance(n_rays), **pairs)

    def _ba_batch(self, setup: BASetup, draws: BADraws):
        """The iteration's rays (rays_o, rays_d, rgb, depth, mask): keyframe
        rays plus current rays, then the active-ray selection. With pose
        optimisation the rays are differentiable in the pose variables (the
        selection itself is discrete)."""
        m = self.cfg.mapper
        cur_cap, num_cur = setup.cur_cap, setup.num_cur
        dev = self.device
        g_rays, g_slots = sample_global_rays(self.kf, draws.g_idx)
        c_rays = setup.frame_rays[setup.valid_order[draws.cur_j]]
        if setup.pose is None:
            g_poses, c_pose = self.poses[g_slots * m.keyframe_every], setup.c2w
        else:
            g_poses = setup.pose.kf_matrices()[g_slots]
            c_pose = setup.pose.cur_matrix()
        g = _transform_rays(g_rays, g_poses)
        c = _transform_rays(c_rays, c_pose.expand(cur_cap, 4, 4))
        if not m.active_ray:
            mask = torch.cat([torch.ones((self._n_os(),), device=dev),
                              (torch.arange(cur_cap, device=dev)
                               < num_cur).to(torch.float32)])
            return (*(torch.cat([a, b]) for a, b in zip(g, c)), mask)

        base, k_sel = m.sample, m.act_ray_num_uncert_sample
        keep_cap = cur_cap // 4
        cand_cap = cur_cap - keep_cap
        num_keep = num_cur // 4
        (g_o, g_d, _, g_dep), (c_o, c_d, _, c_dep) = g, c
        cand_o = torch.cat([g_o[base:], c_o[:cand_cap]])
        cand_d = torch.cat([g_d[base:], c_d[:cand_cap]])
        cand_dep = torch.cat([g_dep[base:], c_dep[:cand_cap]])
        cand_valid = torch.cat([
            torch.ones((self._n_os() - base,), dtype=torch.bool, device=dev),
            torch.arange(cand_cap, device=dev) < num_cur - num_keep])
        pts = (cand_o + cand_d * cand_dep).detach()
        vi = torch.round((pts - self._bound_lo) * (1.0 / m.voxel_size)).long()
        vi = torch.minimum(torch.clamp(vi, min=0), self._vol_max)
        u = self.uncert_vol[vi[:, 0], vi[:, 1], vi[:, 2]]
        score = -u if m.active_select_highest else u
        score = torch.where(cand_valid, score, torch.inf)
        # k smallest scores, ties to the lower index (as jax.lax.top_k)
        sel = torch.sort(score, stable=True).indices[:k_sel]

        def cat(ga, ca):
            return torch.cat([torch.cat([ga[base:], ca[:cand_cap]])[sel],
                              ga[:base - k_sel], ca[cand_cap:]])

        mask = torch.cat([torch.ones((base,), device=dev),
                          (torch.arange(keep_cap, device=dev)
                           < num_keep).to(torch.float32)])
        return (*(cat(a, b) for a, b in zip(g, c)), mask)

    def _ba_iteration(self, setup: BASetup, draws: BADraws, it: int):
        """One BA iteration: batch, loss, gradients, Adam steps.
        Returns (aux, grads)."""
        m = self.cfg.mapper
        batch = self._ba_batch(setup, draws)
        smooth = (draws.smooth_offset, draws.smooth_jitter,
                  draws.smooth_base, draws.smooth_diffc)
        smooth_every = max(int(self.cfg.training.smooth_every), 1)
        scale = 1.0
        # with pose optimisation, as in the JAX package, the smoothness
        # term rides every iteration
        if setup.pose is None and smooth_every > 1:
            if it % smooth_every == 0:
                # the fired iterations carry the whole call's smoothness
                # weight
                scale = m.iters / -(-m.iters // smooth_every)
            else:
                smooth = None
        aux, grads = self._grad_fn(
            *batch, draws.z_noise, smooth, scale,
            importance_u=draws.importance_u,
            pose_leaves=setup.pose.leaves if setup.pose else ())
        self._apply_map_update(grads)
        self._accum_uncert(grads)
        if self.spec.uncert_grid and (it + 1) % m.uncert_accum_iters == 0:
            self._apply_uncert_update()
        if setup.pose is not None:
            setup.pose.accumulate(grads["pose"])
            if (it + 1) % m.pose_accum_step == 0:
                setup.pose.step()
        return aux, grads

    def _ba_impl(self, cur_cap: int, frame_rays, c2w, frame_id: int,
                 draws: Optional[Sequence[BADraws]] = None) -> List[Dict]:
        """One global-BA mapping step; returns each iteration's losses.
        With pose optimisation the optimised poses are written back."""
        setup = self._ba_setup(cur_cap, frame_rays, c2w, frame_id)
        auxes = []
        for it in range(self.cfg.mapper.iters):
            d = draws[it] if draws is not None else self._draw_ba(setup)
            auxes.append(self._ba_iteration(setup, d, it)[0])
        if setup.pose is not None:
            setup.pose.write_back(self.poses, frame_id)
        return auxes

    # ------------------------------------------------------------ tracking
    def _draw_track(self) -> TrackDraws:
        m, dev, g = self.cfg.mapper, self.device, self.gens
        n = m.track_sample
        iw, ih = m.track_ignore_edge_w, m.track_ignore_edge_h
        return TrackDraws(
            us=torch.randint(iw, self.W - iw, (n,), device=dev,
                             generator=g["track_rays"]),
            vs=torch.randint(ih, self.H - ih, (n,), device=dev,
                             generator=g["track_rays"]),
            z_noise=torch.rand((n, self.rc.n_samples), device=dev,
                               generator=g["z_noise"]),
            importance_u=self._draw_importance(n))

    def _tracking_impl(self, frame_rays, init_c2w,
                       draws: Iterable[TrackDraws]) -> torch.Tensor:
        """Camera tracking: pose-only Adam steps against the frozen field
        from init_c2w, one per draw; returns the estimated c2w (the
        lowest-loss iterate with track_best, else the last)."""
        m = self.cfg.mapper
        params = _detached(self.params)
        rot, trans = map(_leaf, pose_to_tensor(init_c2w))
        opt = _pose_adam([rot], [trans], m.lr_rot, m.lr_trans)
        best_loss = torch.tensor(float("inf"), device=self.device)
        best_rot, best_trans = rot.detach().clone(), trans.detach().clone()
        mask = torch.ones((m.track_sample,), device=self.device)
        for d in draws:
            rays = frame_rays[d.vs * self.W + d.us]
            pose = matrix_from_tensor(rot[None], trans[None])
            rays_o, rays_d, rgb, dep = _transform_rays(
                rays, pose.expand(m.track_sample, 4, 4))
            loss, _ = self._loss_fn(rays_o, rays_d, rgb, dep, mask,
                                    d.z_noise, importance_u=d.importance_u,
                                    params=params)
            rot.grad, trans.grad = torch.autograd.grad(loss, (rot, trans))
            with torch.no_grad():
                better = loss < best_loss
                best_rot = torch.where(better, rot, best_rot)
                best_trans = torch.where(better, trans, best_trans)
                best_loss = torch.minimum(best_loss, loss)
            opt.step()
        if m.track_best:
            rot, trans = best_rot, best_trans
        return matrix_from_tensor(rot.detach()[None], trans.detach()[None])[0]

    def _pick_bucket(self, kf_count: int) -> int:
        need = max(self._n_os() // max(kf_count, 1), self._min_cur())
        for b in CUR_BUCKETS:
            if b >= need:
                return b
        return CUR_BUCKETS[-1]

    # ---------------------------------------------------------- keyframes
    def add_keyframe(self, frame_rays, frame_id: int,
                     score_u: Optional[torch.Tensor] = None) -> None:
        if score_u is None:
            score_u = torch.rand((frame_rays.shape[0],), device=self.device,
                                 generator=self.gens["keyframe_scores"])
        add_keyframe(self.kf, frame_rays, frame_id, score_u,
                     depth_trunc=self.lw.depth_trunc,
                     filter_depth=self.cfg.mapper.filter_depth)

    # --------------------------------------------------------- map volumes
    @torch.no_grad()
    def _volumes_impl(self):
        if self._sharded_vol is not None:
            sdf, uncert_map = self._sharded_vol(self.params, self.grid01)
        else:
            sdf, uncert_map = volume_maps(self.params, self.grid01, self.spec)
        return (uncert_map.reshape(self.vol_shape),
                sdf.reshape(self.vol_shape))

    def map_volumes(self):
        """(uncert_vol, sdf_vol) device tensors; refreshes the cached
        uncertainty volume the active-ray selection reads."""
        u, s = self._volumes_impl()
        self.uncert_vol = u
        return u, s

    def get_map_volumes(self):
        return tuple(v.cpu().numpy() for v in self.map_volumes())

    def get_map_volumes_lazy(self) -> LazyVolumes:
        """map_volumes() as a LazyVolumes view (host copy on first read)."""
        return LazyVolumes(*self.map_volumes(), timer=self.timer,
                           stream=self._copy_stream)

    # --------------------------------------------------------------- meshes
    def _save_mesh(self, kind: str, step: int, voxel_size: float,
                   suffix: str, color_mode: str) -> Optional[str]:
        if self.result_dir is None:
            return None
        from naruto_tpu_torch.mesh.extract import save_mesh

        path = os.path.join(self.result_dir, kind,
                            f"mesh_{step:04d}{suffix}.ply")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return save_mesh(self, path, voxel_size=voxel_size,
                         color_mode=color_mode)

    def save_mesh(self, step: int, voxel_size: float = 0.05,
                  suffix: str = "") -> Optional[str]:
        """Periodic mesh snapshot (ref save_mesh, coslam.py:421-458);
        requires result_dir to be set."""
        return self._save_mesh("mesh", step, voxel_size, suffix, "color")

    def save_uncert_mesh(self, step: int, voxel_size: float = 0.05,
                         suffix: str = "") -> Optional[str]:
        """Uncertainty-colored mesh (ref save_uncert_mesh, coslam.py:460)."""
        return self._save_mesh("uncert_mesh", step, voxel_size, suffix,
                               "uncert")

    # ------------------------------------------------------------ online API
    def _t(self, name: str):
        """Timer section under the [Mapper] group (no-op without a timer)."""
        if self.timer is None:
            return contextlib.nullcontext()
        return self.timer.time(name, "Mapper")

    def needs_frame(self, i: int) -> bool:
        """True when step i consumes the RGB-D frame: first frame, tracking
        enabled, a mapping step, or a keyframe step. The engine renders
        no other frame."""
        m = self.cfg.mapper
        return (i == 0 or self.track_enabled
                or i % m.map_every == 0 or i % m.keyframe_every == 0)

    def online_recon_step(self, i: int, color, depth, c2w):
        """One mapping step. Returns the (uncert_vol, sdf_vol) LazyVolumes
        on mapping steps (step 0 and every map_every), else None.
        color/depth may be None when needs_frame(i) is False."""
        m = self.cfg.mapper
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=self.device)
        frame_rays = None
        if self.needs_frame(i):
            with self._t("frame_transfer"):
                frame_rays = self.frame_to_rays(color, depth)
        vols = None

        # periodic mesh snapshot (ref coslam.py:571-574)
        if self.result_dir is not None and i % self.cfg.mesh.vis_freq == 0:
            with self._t("mesh_snapshot"):
                self.save_mesh(i, voxel_size=self.cfg.mesh.voxel_eval)

        if i == 0:
            self.printer("First frame mapping...", i, "Mapper")
            with self._t("first_frame"):
                self.last_aux = self._first_frame_impl(
                    frame_rays, c2w,
                    (self._draw_first_frame() for _ in range(m.first_iters)))
            self.add_keyframe(frame_rays, 0)
            self._pending_vols = self.get_map_volumes_lazy()
            return self._pending_vols
        if self.track_enabled:
            # pose-only optimisation from the constant-speed model
            prev, prev2 = self.poses[i - 1], self.poses[max(i - 2, 0)]
            init = (const_speed_init(prev, prev2)
                    if m.track_const_speed and i >= 2 else prev)
            with self._t("tracking"):
                c2w = self._tracking_impl(
                    frame_rays, init,
                    (self._draw_track() for _ in range(m.track_iter)))
        self.poses[i] = c2w
        if i % m.map_every == 0:
            bucket = self._pick_bucket(self.kf.count)
            self.printer(f"Global BA (bucket={bucket})", i, "Mapper")
            # at most one mapping step in flight: the previous step's
            # volumes exist on the device before this BA is enqueued
            if self._pending_vols is not None:
                with self._t("ba_drain"):
                    self._pending_vols.ready()
            with self._t("ba_dispatch"):
                self.last_aux = self._ba_impl(bucket, frame_rays, c2w, i)
            with self._t("volumes_dispatch"):
                vols = self._pending_vols = self.get_map_volumes_lazy()
        if i % m.keyframe_every == 0:
            with self._t("keyframe_add"):
                self.add_keyframe(frame_rays, i)
        return vols

    # ----------------------------------------------------------- query API
    @torch.no_grad()
    def predict_sdf(self, pts_world: np.ndarray,
                    chunk: int = 1 << 17) -> np.ndarray:
        """SDF at world points [N, 3] (host numpy in and out)."""
        bound = self.spec.bound_np
        x01 = torch.from_numpy(
            (np.asarray(pts_world, dtype=np.float32) - bound[:, 0])
            / (bound[:, 1] - bound[:, 0])).to(self.device)
        outs = [query_sdf(self.params, x01[s:s + chunk], self.spec)
                for s in range(0, x01.shape[0], chunk)]
        return (torch.cat(outs).cpu().numpy() if outs
                else np.zeros((0,), np.float32))

    # ----------------------------------------------------------- checkpoint
    def _ckpt_tree(self) -> Dict:
        return {"params": self.params, "poses": self.poses}

    def save_ckpt(self, path: str) -> None:
        """Poses + field params (ref save_ckpt coslam.py:494-517), as the
        JAX package's versioned npz (utils/ckpt_io.py): the JAX Mapper's
        load_ckpt reads it."""
        ckpt_io.save_tree(path, self._ckpt_tree(),
                          meta={"kind": "eval_ckpt", "step": int(self.step),
                                "grid_layout": self.cfg.grid.layout})

    def _check_param_compat(self, loaded_params: Dict) -> None:
        """Fail fast with a config hint when a checkpoint was written under
        a different table layout/shape."""
        cur = self.params
        lk, ck = set(loaded_params), set(cur)
        mism = [f"param set differs: ckpt has {sorted(lk - ck)} extra, "
                f"missing {sorted(ck - lk)}"] if lk != ck else []
        for k in sorted(lk & ck):
            ls = [tuple(np.shape(x)) for _, x in
                  ckpt_io.flatten_with_keys(loaded_params[k])]
            cs = [tuple(x.shape) for _, x in
                  ckpt_io.flatten_with_keys(cur[k])]
            if ls != cs:
                mism.append(f"{k}: ckpt leaf shapes {ls} vs configured {cs}")
        if mism:
            raise ValueError(
                "checkpoint incompatible with the configured field "
                "(likely saved under a different grid.layout / grid size — "
                "set grid.layout to match the run that wrote it): "
                + "; ".join(mism))

    def load_ckpt(self, path: str) -> None:
        """Params, poses and step from a save_ckpt file of either package."""
        blob, meta = ckpt_io.load_tree(path, self._ckpt_tree())
        self.load_weights(blob["params"])
        self.poses = torch.from_numpy(
            np.asarray(blob["poses"], np.float32)).to(self.device)
        self.step = int(meta.get("step", 0))

    # ---------------------------------------------------- full-state resume
    def _full_state_tree(self) -> Dict:
        """The mapper's state as the JAX package's MapperState tree (a dict
        of its fields), under its leaf names: the decoder's torch Adam as
        optax's (add_decayed_weights, scale_by_adam, scale) chain state,
        the table's EmbedAdam as EmbedAdamState, the uncertainty grid's
        Adam as (scale_by_adam, scale); scalars where there is no
        uncertainty grid, as the JAX package keeps them."""
        node = ckpt_io.named_node
        table = self.params["table"]
        dec = self._groups["decoder"]
        n_sdf = len(self.params["sdf_mlp"])
        d_count, d_mu, d_nu = _adam_state(self.decoder_opt, dec)

        def dec_tree(leaves):
            return {"sdf_mlp": leaves[:n_sdf], "color_mlp": leaves[n_sdf:]}

        if self.spec.uncert_grid:
            u_count, (u_mu,), (u_nu,) = _adam_state(self.uncert_opt,
                                                    self._groups["uncert"])
            u_accum = self.uncert_accum
        else:
            u_count = 0
            u_mu = u_nu = u_accum = np.zeros((), np.float32)
        return {
            "params": self.params,
            "map_opt_state": {
                "embed": node("EmbedAdamState",
                              count=_i32(self.embed_opt.count),
                              mu=_like_table(table, self.embed_opt.mu),
                              nu=_like_table(table, self.embed_opt.nu)),
                "decoder": (node("EmptyState"),
                            node("ScaleByAdamState", count=_i32(d_count),
                                 mu=dec_tree(d_mu), nu=dec_tree(d_nu)),
                            node("EmptyState"))},
            "uncert_opt_state": (node("ScaleByAdamState",
                                      count=_i32(u_count), mu=u_mu,
                                      nu=u_nu),
                                 node("EmptyState")),
            "uncert_accum": u_accum,
            "kf": node("KeyframeDB", rays=self.kf.rays,
                       frame_ids=self.kf.frame_ids,
                       count=_i32(self.kf.count)),
            "poses": self.poses,
            "uncert_vol": self.uncert_vol,
        }

    def save_full_state(self, path: str, extra: Optional[Dict] = None,
                        generators: Optional[Dict] = None) -> None:
        """The full state as the JAX package's npz snapshot: its MapperState
        tree, and a header with step, grid_layout, `extra` (a small
        JSON-able dict: the pose, the planner's state) and, under
        GENERATORS_KEY, the state of every draw site's generator and of
        `generators` (others' draw sites, e.g. the planner's). The JAX
        package's load_full_state reads it (and ignores the generators)."""
        meta = {"kind": "full_state", "step": int(self.step),
                "grid_layout": self.cfg.grid.layout,
                GENERATORS_KEY: generator_states(
                    {**self.gens, **(generators or {})})}
        if extra:
            meta["extra"] = extra
        ckpt_io.save_tree(path, self._full_state_tree(), meta=meta)

    @torch.no_grad()
    def load_full_state(self, path: str,
                        generators: Optional[Dict] = None) -> Dict:
        """Restore a full-state snapshot of either package; returns the
        header's `extra`. The generators (this mapper's and `generators`)
        take the states of GENERATORS_KEY; a JAX snapshot has none (its
        threefry key is no torch generator state), so after one the draws
        continue from this mapper's seed. The JAX package's older pickle
        snapshots are refused."""
        if ckpt_io.is_legacy_pickle(path):
            raise ValueError(
                f"{path} is a pickle snapshot (the JAX package's format "
                "before its npz checkpoints); the port reads only the npz "
                "format of utils/ckpt_io.py: re-save it with the JAX "
                "package's save_full_state")
        blob, meta = ckpt_io.load_tree(path, self._full_state_tree())
        self.load_weights(blob["params"])
        emb = blob["map_opt_state"]["embed"]
        self.embed_opt.count = int(emb.count)
        for dst, src in zip(self.embed_opt.mu + self.embed_opt.nu,
                            table_leaves(emb.mu) + table_leaves(emb.nu)):
            _copy_into(dst, src)
        dec = blob["map_opt_state"]["decoder"][1]
        _set_adam_state(self.decoder_opt, self._groups["decoder"],
                        int(dec.count),
                        [*dec.mu["sdf_mlp"], *dec.mu["color_mlp"]],
                        [*dec.nu["sdf_mlp"], *dec.nu["color_mlp"]])
        if self.spec.uncert_grid:
            un = blob["uncert_opt_state"][0]
            _set_adam_state(self.uncert_opt, self._groups["uncert"],
                            int(un.count), [un.mu], [un.nu])
            _copy_into(self.uncert_accum, blob["uncert_accum"])
        kf = blob["kf"]
        _copy_into(self.kf.rays, kf.rays)
        _copy_into(self.kf.frame_ids, kf.frame_ids)
        self.kf.count = int(kf.count)
        _copy_into(self.poses, blob["poses"])
        _copy_into(self.uncert_vol, blob["uncert_vol"])
        self.step = int(meta.get("step", 0))
        self._pending_vols = None
        states = meta.get(GENERATORS_KEY)
        if states:
            set_generator_states({**self.gens, **(generators or {})},
                                 states)
        return meta.get("extra", {})
