"""Typed configuration tree: the port's own copy of
naruto_tpu/config/schema.py, field for field, so that a config built here
equals the JAX package's.

Replaces the reference's three-tier config stack (mmengine python configs with
``_base_`` inheritance + YAML with ``inherit_from`` deep-merge + per-scene
habitat configs — SURVEY.md §5.6) with one typed dataclass tree. Defaults
reproduce the shipped Replica values (configs/Replica/replica_coslam.yaml,
configs/default.py in the reference).

All shapes (ray counts, sample counts, grid sizes) are plain ints.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

Bound = Tuple[Tuple[float, float], Tuple[float, float], Tuple[float, float]]


@dataclass
class GeneralConfig:
    seed: int = 0
    dataset: str = "Replica"
    scene: str = "office0"
    num_iter: int = 2000            # ref: configs/default.py:11
    result_dir: str = "results"
    data_dir: str = "data"
    # mid-run full-state checkpoint cadence (0 = final only; the reference
    # checkpoints only at run end — SURVEY.md §5.4)
    ckpt_freq: int = 0
    # run the full metric row (acc/comp/ratio/MAD) at finalize when a GT
    # mesh is available (ref eval_replica.sh pipeline)
    final_eval: bool = True


@dataclass
class CamConfig:
    # ref: configs/Replica/replica_coslam.yaml cam section
    H: int = 680
    W: int = 1200
    fx: float = 600.0
    fy: float = 600.0
    cx: float = 599.5
    cy: float = 339.5
    near: float = 0.0
    far: float = 5.0
    depth_trunc: float = 100.0
    png_depth_scale: float = 6553.5
    crop_edge: int = 0
    downsample: int = 1

    @property
    def intrinsics(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]],
            dtype=np.float32,
        )


@dataclass
class GridConfig:
    # ref: replica_coslam.yaml grid section (tcnn HashGrid: 16 levels x 2
    # features). The TPU-fast default keeps the same 32-dim output and total
    # capacity but splits it as 4 levels x 8 features with bf16 gathers: TPU
    # gather/sort costs scale with random-access row count, and L4F8+bf16
    # cuts the hot-loop cost ~3x (see ops/encoding.py). Set (16, 2,
    # "float32") to reproduce the reference hyperparameters exactly.
    enc: str = "HashGrid"
    hash_size: int = 16             # log2 of table entries per level
    n_levels: int = 4
    n_features_per_level: int = 8
    table_dtype: str = "bfloat16"
    # "vertex" = exact instant-ngp/tcnn vertex-keyed rows; "cell" = one row
    # per cell with all 8 corner features contiguous (wide-row gathers are
    # ~6x faster on TPU and the backward sorts 8x fewer keys; corners are
    # per-cell copies); "hybrid" = cell-speed reads with TRUE shared-vertex
    # parameters on the dense coarse levels (their wide rows are derived by
    # 8 static slices each evaluation — exact tcnn semantics there; only
    # hashed fine levels keep per-cell copies). Default "hybrid"; set
    # "vertex" (or load configs/parity.yaml) for exact tcnn semantics on
    # every level. Quality A/B in PERFORMANCE.md.
    layout: str = "hybrid"
    # cell/hybrid gradient sort payload: "frac" (one 3x10-bit packed-frac
    # column, weights recomputed post-sort; ~33% slimmer sort at <=0.3%
    # weight quantization — the same order as the "weights" path's bf16
    # rounding; see ops/segment.pack_frac) | "weights" (exact-to-bf16
    # corner weights, 4 packed columns). Default "frac" per the r4
    # bracketed A/B: 47.8 vs 43.2 it/s (+10.5%, results/r4_hw_queue.log).
    sort_carry: str = "frac"
    base_resolution: int = 16
    voxel_sdf: float = 0.02         # finest resolution = max bbox len / this
    voxel_color: float = 0.08
    one_grid: bool = True           # oneGrid: color net reuses geometry grid
    # position (one-blob) encoding — ref: replica_coslam.yaml pos section
    pos_enc: str = "OneBlob"
    pos_n_bins: int = 16


@dataclass
class DecoderConfig:
    # ref: replica_coslam.yaml decoder section
    geo_feat_dim: int = 15
    hidden_dim: int = 32
    num_layers: int = 2
    hidden_dim_color: int = 32
    num_layers_color: int = 2
    pred_uncert: bool = False       # uncertainty as extra MLP output channel
    uncert_grid: bool = True        # uncertainty as learnable voxel grid


@dataclass
class TrainingConfig:
    # ref: replica_coslam.yaml training section
    rgb_weight: float = 5.0
    depth_weight: float = 0.1
    sdf_weight: float = 1000.0
    fs_weight: float = 10.0
    uncert_weight: float = 0.005
    eikonal_weight: float = 0.0
    smooth_weight: float = 1e-6
    smooth_pts: int = 32
    smooth_vox: float = 0.1
    smooth_margin: float = 0.05
    # 0 = reference full-grid TV; >0 = Monte-Carlo TV from this many
    # random grid pairs per axis (cuts ~30k extra field points/iter)
    smooth_sample: int = 0
    # 1 = reference cadence (smoothness every BA iteration); k>1 = pay the
    # regularizer rider only every k-th iteration, scaled by
    # iters/ceil(iters/k) so the TOTAL smoothness weight per BA call
    # exactly matches the every-iteration baseline (skipped iterations
    # execute a smaller compiled branch). Default 1 for exact reference
    # numerics.
    smooth_every: int = 1
    n_samples_d: int = 32           # uniform samples near..far
    range_d: float = 0.1            # +- range around measured depth
    n_range_d: int = 11             # depth-guided samples
    n_importance: int = 0
    perturb: float = 1.0
    white_bkgd: bool = False
    trunc: float = 0.1
    sc_factor: float = 1.0
    rot_rep: str = "axis_angle"
    rgb_missing: float = 0.05


@dataclass
class MapperConfig:
    # ref: replica_coslam.yaml mapping section + slam section of default.py
    sample: int = 2048
    iters: int = 10
    lr_embed: float = 0.01
    lr_decoder: float = 0.01
    lr_rot: float = 0.001
    lr_trans: float = 0.001
    keyframe_every: int = 5
    map_every: int = 5
    n_pixels: float = 0.05          # fraction of pixels stored per keyframe
    first_iters: int = 200
    optim_cur: bool = True
    min_pixels_cur: int = 100
    map_accum_step: int = 1
    pose_accum_step: int = 5
    map_wait_step: int = 0
    filter_depth: bool = True
    # active ray sampling — ref: configs/default.py:72-76
    active_ray: bool = True
    act_ray_oversample_mul: int = 4
    act_ray_num_uncert_sample: int = 500
    # the reference's argpartition picks the K LOWEST-uncertainty candidates
    # (active_ray_sampler.py:127) though its docstring says highest; False
    # reproduces the shipped behavior, True follows the paper's description
    active_select_highest: bool = False
    # True = TPU-native jax.lax.approx_max_k for the K-of-oversample
    # selection (recall ~0.95; the selection is a sampling heuristic, so a
    # near-miss set is statistically equivalent). False = exact top_k,
    # matching the reference's argpartition semantics.
    approx_topk: bool = False
    # scene AABB (meters) — ref: configs/<ds>/<scene>/coslam.yaml
    bound: Bound = ((-2.2, 2.6), (-3.4, 2.1), (-1.4, 2.0))
    marching_cubes_bound: Bound = ((-2.2, 2.6), (-3.4, 2.1), (-1.4, 2.0))
    # uncertainty/SDF volume voxel size — ref: configs/default.py:65
    voxel_size: float = 0.1
    # tracking (disabled in every shipped config — ref: replica_coslam.yaml:30)
    tracking_enable: bool = False
    track_iter: int = 10
    track_sample: int = 1024
    track_ignore_edge_w: int = 20
    track_ignore_edge_h: int = 20
    track_best: bool = True
    track_const_speed: bool = True
    # uncertainty-grid optimizer — ref: coslam.py:240-243,397-399
    lr_uncert: float = 1.0
    uncert_accum_iters: int = 5

    @property
    def bound_np(self) -> np.ndarray:
        return np.asarray(self.bound, dtype=np.float32)

    @property
    def mc_bound_np(self) -> np.ndarray:
        return np.asarray(self.marching_cubes_bound, dtype=np.float32)


@dataclass
class MeshConfig:
    # ref: replica_coslam.yaml mesh section
    resolution: int = 512
    render_color: bool = False
    vis_freq: int = 500
    voxel_eval: float = 0.05
    voxel_final: float = 0.02


@dataclass
class PlannerConfig:
    # ref: configs/default.py planner section
    method: str = "naruto"
    enable_active_planning: bool = True
    enable_timing: bool = False
    step_size: float = 0.1                  # meters
    voxel_size: float = 0.1                 # uncertainty volume voxel size
    uncert_top_k: int = 4000
    uncert_top_k_subset: int = 300
    gs_sensing_range: Tuple[float, float] = (0.5, 2.0)   # meters
    safe_sdf: float = 0.8                   # voxels
    force_uncert_aggre: bool = False
    gs_z_levels: Optional[List[int]] = None  # None -> default [5, 11, 17]
    obs_per_goal: int = 10
    enable_uncert_filtering: bool = True
    up_dir: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    local_planner_method: str = "RRTNaruto"
    invalid_region_ratio_thre: float = 0.5
    collision_dist_thre: float = 0.05       # meters
    max_rot_deg: float = 10.0
    # RRT — ref: configs/default.py:117-126
    rrt_step_size: float = 1.0              # voxels (= step_size / voxel_size)
    rrt_step_amplifier: int = 10
    rrt_maxz: int = 100
    rrt_max_iter: Optional[int] = None
    rrt_z_levels: Optional[List[int]] = None
    rrt_z_range: Optional[List[int]] = None
    enable_eval: bool = False
    enable_direct_line: bool = True
    collision_thre: float = 0.5             # voxels (SDF collision threshold)
    # Exploration mitigation (DEVIATION, default off = exact reference
    # lifecycle): every k-th plan, reset the traversability mask to ones
    # so regions masked out by an EARLY failed RRT are retried against the
    # since-improved map. The reference (naruto_planner.py:330-393) keeps
    # a failed-RRT mask forever unless aggregation finds no valid goals —
    # a stale mask can permanently hide real uncertainty and stall
    # coverage (the weak-seed diagnosis, VERDICT r3 #6). 0 disables.
    trav_mask_decay: int = 0
    # Exploration mitigation #2 (DEVIATION, default off): scale each
    # goal's aggregated uncertainty by 1/(1 + p*attempts) before the
    # argmax, where attempts = times chosen + move-time collisions while
    # pursuing it. The r4 raycast-seed diagnostics show weak seeds
    # re-selecting ONE goal up to 9/41 plans (its uncertainty never
    # resolves — e.g. unobservable from the reachable side), and the
    # seed_1999 livelock re-plans one truly-impassable goal 159x through
    # a collision->staying cycle the traversability mask never sees
    # (RRT succeeds on the optimistic learned SDF, so the mask is never
    # rebuilt); the reference argmax (naruto_planner.py:462-510)
    # re-spends that budget every plan. 0.0 disables.
    goal_repeat_penalty: float = 0.0
    # Exploration mitigation #3 (DEVIATION, default off): when the
    # learned-SDF line check flags a collision but a simulator ERP probe
    # at the next pose reports >= this much real clearance (meters) and
    # a valid-depth ratio within invalid_region_ratio_thre, allow the
    # move. The reference's Replica combo is SDF-only
    # (naruto_planner.py:573-575 — its probe-based variant is present
    # but commented out), so it livelocks when the learned field closes
    # a narrow real corridor: raycast seed_1999 got wedged ~12 cm from
    # real geometry and the field's slightly inflated surfaces pushed
    # every first-hop line below the 5 cm collision threshold — 142
    # collision->staying cycles, 74.6% final ratio vs 94.6-98.7% for
    # the other seeds (checkpoint replay: real clearance along the
    # blocked lines was 5.5-25.5 cm). The probe only fires when the SDF
    # already said collision, so parity runs never pay it. 0.0 disables.
    collision_sim_override: float = 0.0
    # DEVIATION #12 (default ON, PARITY.md): draw the 300-target subset
    # of the top-k uncertain voxels weighted toward NONZERO entries, so
    # sparse uncertainty volumes still yield usable targets. The
    # reference takes an arbitrary argpartition slice of the top-k
    # (naruto_planner.py:625-630) — an unweighted, order-unspecified
    # subset. False = exact-reference semantics (uniform unweighted
    # draw from the top-k).
    subset_nonzero_weighted: bool = True


@dataclass
class SimConfig:
    method: str = "analytic"    # analytic | replay | raycast
    scene_path: str = ""        # mesh file (raycast) or frames dir (replay)
    # habitat stage_config.json (MP3D ships one per scene, e.g.
    # configs/MP3D/gZ6f7yhEvPG/mp3d.stage_config.json): resolves
    # render_asset relative to the json and applies its up/front
    # orientation, so real MP3D assets work untouched. Overrides
    # scene_path when set.
    stage_config: str = ""
    # explicit stage orientation (habitat semantics: rotate so up -> +Y,
    # front -> -Z); None = identity / take from stage_config
    stage_up: Optional[List[float]] = None
    stage_front: Optional[List[float]] = None
    # pinhole sensor — ref: configs/Replica/office0/habitat.py camera section
    pinhole_hw: Tuple[int, int] = (680, 1200)
    focal: float = 600.0
    # equirectangular sensor (collision sensing)
    erp_hw: Tuple[int, int] = (1024, 2048)
    # collision-probe resolution override. The planner's detect_collision
    # consumes only GLOBAL statistics of the probe (min distance +
    # invalid-pixel ratio, ref naruto_planner.py:534-541), so on host-
    # render-bound scenes (NARUTO glb, 1-core box) a reduced probe grid
    # is a measured-cost knob: 256x512 cuts the 0.8 s/step hokage_room
    # probe ~16x while nearby obstacles (the ones under
    # collision_dist_thre) still subtend many probe pixels. None = probe
    # at erp_hw (bit-exact reference semantics; PARITY.md deviation #13).
    probe_hw: Optional[Tuple[int, int]] = None
    invalid_depth_value: float = 1e8   # ref: habitat_simulator.py:142
    analytic_scene: str = "box_room"   # analytic backend scene preset
    # dynamic rigid objects for the raycast backend — parity with the
    # reference's object profiles (habitat_utils.py:342-426). Each entry:
    # {template: "sphere:0.2" | "box:..." | mesh path,
    #  location/velocity/angular_velocity: [x,y,z] in the START camera
    #  frame, rotation: [deg, ax, ay, az]}
    objects: Optional[List[Dict[str, Any]]] = None
    # per-frame physics step (s); 0 = objects only settle once at init
    # (active-loop parity); the reference's scripted loop uses 1/30
    physics_dt: float = 0.0
    # gravity magnitude along world -z (the reference sets [0,-10,0] in
    # habitat's frame and Bullet settles contacts for 1.0 s at init —
    # habitat.py:31, habitat_simulator.py:78). Approximated here as a
    # drop-to-first-support along -z via one raycast per object per
    # physics step. 0 keeps pure constant-velocity kinematics (default:
    # the shipped motion profiles describe airborne objects).
    gravity: float = 0.0


@dataclass
class VisConfig:
    # ref: configs/default.py visualizer section
    vis_rgbd: bool = False
    mesh_vis_freq: int = 500
    enable_all_vis: bool = False
    save_rgbd: bool = True
    save_pose: bool = True
    save_planning_path: bool = True
    save_lookat_tgts: bool = True
    save_state: bool = True
    save_color_mesh: bool = True
    save_uncert_mesh: bool = True
    save_mesh_freq: int = 5
    save_mesh_voxel_size: float = 0.05


@dataclass
class ParallelConfig:
    """TPU sharding layout (no reference counterpart — SURVEY.md §2.7)."""
    mesh_shape: Tuple[int, ...] = (1,)   # devices along the 'data' (ray) axis
    axis_names: Tuple[str, ...] = ("data",)
    shard_rays: bool = False             # shard the ray batch over 'data'
    shard_volumes: bool = False          # shard dense volume queries


@dataclass
class MainConfig:
    general: GeneralConfig = field(default_factory=GeneralConfig)
    cam: CamConfig = field(default_factory=CamConfig)
    grid: GridConfig = field(default_factory=GridConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    mapper: MapperConfig = field(default_factory=MapperConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    planner: PlannerConfig = field(default_factory=PlannerConfig)
    sim: SimConfig = field(default_factory=SimConfig)
    vis: VisConfig = field(default_factory=VisConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    # active planning / pose source — ref: configs/default.py slam section
    enable_active_planning: bool = True
    use_traj_pose: bool = False
    # per-scene initial camera pose (4x4 RDF c2w, row-major nested lists) —
    # ref: configs/<ds>/<scene>/NARUTO.py `start_c2w`
    # (e.g. configs/MP3D/gZ6f7yhEvPG/NARUTO.py:44-48). None = unset, in
    # which case active asset-free runs fall back to the room center.
    start_c2w: Optional[List[List[float]]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "MainConfig":
        return dataclasses.replace(self, **kw)


def deep_update(cfg: Any, overrides: Dict[str, Any]) -> Any:
    """Apply a nested dict of overrides onto a dataclass tree (returns a new
    tree). Mirrors the semantics of the reference's `update_recursive`
    (src/utils/config_utils.py:63-76) on typed configs."""
    updates = {}
    for key, val in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config key: {key!r} on {type(cfg).__name__}")
        cur = getattr(cfg, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            updates[key] = deep_update(cur, val)
        elif dataclasses.is_dataclass(cur) and val is None:
            # an empty YAML section (`decoder:`) parses to None — treat it
            # as "no overrides", never as replacing the whole subtree
            continue
        else:
            updates[key] = val
    return dataclasses.replace(cfg, **updates)
