"""mesh (PyTorch port): isosurfacing, PLY IO and extraction from the field."""
from naruto_tpu_torch.mesh.marching import marching_cubes
from naruto_tpu_torch.mesh.ply import write_ply, read_ply
from naruto_tpu_torch.mesh.extract import extract_mesh, save_mesh

__all__ = ["marching_cubes", "write_ply", "read_ply", "extract_mesh",
           "save_mesh"]
