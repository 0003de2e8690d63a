"""visualization (PyTorch port): the per-step artifact saver, the offline
tools over its directory, and the rasteriser both draw with."""
from naruto_tpu_torch.visualization.saver import ArtifactSaver

__all__ = ["ArtifactSaver"]
