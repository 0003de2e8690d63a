"""sim (PyTorch port): the simulator factory and its backends."""
from naruto_tpu_torch.sim.analytic import AnalyticSimulator
from naruto_tpu_torch.sim.base import Simulator


def init_simulator(cfg, device="cuda", printer=None):
    """Simulator factory (counterpart of naruto_tpu/sim/__init__.py); the
    port has the analytic backend so far."""
    method = cfg.sim.method
    if method == "analytic":
        return AnalyticSimulator(cfg, device, printer)
    if method in ("replay", "raycast"):
        raise NotImplementedError(
            f"sim.method={method!r} is not ported yet (ROADMAP queue 1, "
            f"item 9); the port has sim.method='analytic'")
    raise ValueError(f"unknown simulator method: {method}")


__all__ = ["Simulator", "AnalyticSimulator", "init_simulator"]
