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

# the draw sites: the mapper's (see mapping/mapper.py), the planner's
# target subset (planner/naruto_planner.py), then the mapper's tracking
# pixels, importance draws and Monte-Carlo smoothness pairs. A site is
# seeded from its index, so a new site goes at the end: the others keep
# their draws.
SITES = ("init", "first_frame_rays", "global_rays", "current_rays",
         "z_noise", "smoothness", "keyframe_scores", "planner_subset",
         "track_rays", "importance_u", "smooth_pairs")


def make_generator(seed: int, site: str, device) -> torch.Generator:
    """The generator of one draw site, on `device`, seeded from (seed, site
    index) through numpy's SeedSequence."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, SITES.index(site)])
                      .generate_state(1, np.uint64)[0]))
    return g


def make_generators(seed: int, device) -> Dict[str, torch.Generator]:
    """One generator per draw site, each seeded independently."""
    return {site: make_generator(seed, site, device) for site in SITES}
