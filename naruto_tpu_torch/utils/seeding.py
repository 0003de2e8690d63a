"""Deterministic seeding (counterpart of naruto_tpu/utils/seeding.py).

The JAX package derives every device draw from one ``jax.random`` key; the
port gives each draw site its own ``torch.Generator`` on the run's device,
seeded from (run seed, site index). JAX's threefry and torch's Philox never
agree, so the two packages are compared with the draws passed in, not with
seeds.

A run's draws resume where they stopped: ``generator_states`` captures
every generator's state (a Philox seed and offset on a card, the Mersenne
Twister on the host) as JSON-able text for a snapshot's header, and
``set_generator_states`` puts it back before the next draw.
"""
from __future__ import annotations

import base64
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


def generator_states(gens: Dict[str, torch.Generator]) -> Dict[str, str]:
    """{name: base64 of the generator's state} for a JSON header."""
    return {k: base64.b64encode(g.get_state().numpy().tobytes()).decode()
            for k, g in gens.items()}


def set_generator_states(gens: Dict[str, torch.Generator],
                         states: Dict[str, str]) -> None:
    """Restore the generators named in `states` (the others keep theirs);
    a name with no generator here is an error."""
    unknown = sorted(set(states) - set(gens))
    if unknown:
        raise ValueError(f"generator states for unknown draw sites "
                         f"{unknown}; this build has {sorted(gens)}")
    for k, text in states.items():
        raw = np.frombuffer(base64.b64decode(text), dtype=np.uint8).copy()
        gens[k].set_state(torch.from_numpy(raw))
