"""planner (PyTorch port): the NARUTO planner and its factory."""
from naruto_tpu_torch.planner.naruto_planner import NarutoPlanner


def init_planner(cfg, device="cuda", printer=None, timer=None):
    """Planner factory (ref: src/planner/__init__.py:31-50)."""
    method = cfg.planner.method
    if method == "naruto":
        return NarutoPlanner(cfg, device, printer, timer)
    raise ValueError(f"unknown planner method: {method}")


__all__ = ["NarutoPlanner", "init_planner"]
