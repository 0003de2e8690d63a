"""sim (PyTorch port): the simulator factory and its backends."""
from naruto_tpu_torch.sim.analytic import AnalyticSimulator
from naruto_tpu_torch.sim.base import Simulator


def init_simulator(cfg, device="cuda", printer=None):
    """Simulator factory (counterpart of naruto_tpu/sim/__init__.py): the
    analytic scenes, the raycast renderer over a scene mesh and the replay
    of recorded frames."""
    method = cfg.sim.method
    if method == "analytic":
        return AnalyticSimulator(cfg, device, printer)
    if method == "raycast":
        from naruto_tpu_torch.sim.raycast import RaycastSimulator

        return RaycastSimulator(cfg, device, printer)
    if method == "replay":
        # config-time guard, as in the JAX package: recorded data carries
        # no ERP sensor, and MP3D/NARUTO active planning probes the sim's
        # ERP for collisions
        if (cfg.enable_active_planning
                and cfg.general.dataset in ("MP3D", "NARUTO")):
            raise ValueError(
                f"sim.method='replay' cannot serve {cfg.general.dataset} "
                "active planning: its collision rule probes the simulator's "
                "ERP sensor and replay data has none. Use sim.method="
                "'raycast' (or 'analytic'), or disable active planning "
                "(passive replay).")
        from naruto_tpu_torch.sim.replay import ReplaySimulator

        return ReplaySimulator(cfg, device, printer)
    raise ValueError(f"unknown simulator method: {method}")


__all__ = ["Simulator", "AnalyticSimulator", "init_simulator"]
