from naruto_tpu_torch.evaluation.recon import (
    eval_mesh, sample_surface_points, nearest_distances,
)
from naruto_tpu_torch.evaluation.mad import eval_mad
from naruto_tpu_torch.evaluation.traj import eval_traj_length
from naruto_tpu_torch.evaluation.cull import cull_mesh

__all__ = ["eval_mesh", "sample_surface_points", "nearest_distances",
           "eval_mad", "eval_traj_length", "cull_mesh"]
