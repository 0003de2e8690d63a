"""Deterministic seeding (counterpart of naruto_tpu/utils/seeding.py).

The JAX package derives every device draw from one ``jax.random`` key; the
port gives each draw site its own ``torch.Generator`` on the run's device,
seeded from (run seed, site index). JAX's threefry and torch's Philox never
agree, so the two packages are compared with the draws passed in, not with
seeds.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# the mapper's draw sites (see mapping/mapper.py)
SITES = ("init", "first_frame_rays", "global_rays", "current_rays",
         "z_noise", "smoothness", "keyframe_scores")


def make_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """One generator per draw site, on `device`, each seeded independently
    from (seed, site index) through numpy's SeedSequence."""
    gens = {}
    for i, site in enumerate(SITES):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([seed, i])
                          .generate_state(1, np.uint64)[0]))
        gens[site] = g
    return gens
