"""system (PyTorch port): the engine's passive path and the pose source."""
from naruto_tpu_torch.system.engine import Engine
from naruto_tpu_torch.system.pose_loader import PoseLoader

__all__ = ["Engine", "PoseLoader"]
