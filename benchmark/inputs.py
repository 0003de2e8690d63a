"""What the benchmark makes from ``--seed`` and hands to both the program
and the reference: the field's initial weights and the seeds of the
mapper's draw sites.

The weights are drawn on the device by one ``torch.Generator`` in one call,
split into the leaves as the field initialises them: the hash table
uniform in [-1e-4, 1e-4] (tcnn's init), each MLP matrix [in, out] uniform
in +-1/sqrt(in) (torch's Linear init), the uncertainty grid 3.0.
"""
from __future__ import annotations

import zlib
from typing import Dict, List

import numpy as np
import torch

from reference import param_shapes


def site_seed(seed: int, site: str) -> int:
    """The seed of one draw site's generator: (run seed, the site's name)
    through numpy's SeedSequence, so any whole number up to 2**63 serves."""
    return int(np.random.SeedSequence([int(seed), zlib.crc32(site.encode())])
               .generate_state(1, np.uint64)[0])


def generators(seed: int, sites, device) -> Dict[str, torch.Generator]:
    """One generator per named draw site, seeded by site_seed."""
    out = {}
    for s in sites:
        g = torch.Generator(device=device)
        g.manual_seed(site_seed(seed, s))
        out[s] = g
    return out


def reseed(gens: Dict[str, torch.Generator], seed: int) -> None:
    """Seed each generator of `gens` (the program's draw sites) in place."""
    for site, g in gens.items():
        g.manual_seed(site_seed(seed, site))


def weights(cfg: dict, seed: int, device) -> Dict[str, List[torch.Tensor]]:
    """{"table": [...], "decoder": [...], "uncert": [grid]} float32 leaves
    on `device` (reference.param_shapes' shapes)."""
    shapes = param_shapes(cfg)
    sizes = [int(np.prod(s)) for k in ("table", "decoder") for s in shapes[k]]
    g = torch.Generator(device=device)
    g.manual_seed(site_seed(seed, "weights"))
    u = torch.rand(sum(sizes), generator=g, device=device)
    parts = iter(torch.split(u, sizes))
    table = [next(parts).reshape(s) * 2e-4 - 1e-4 for s in shapes["table"]]
    dec = []
    for s in shapes["decoder"]:
        b = 1.0 / s[0] ** 0.5
        dec.append(next(parts).reshape(s) * (2 * b) - b)
    unc = [torch.full(shapes["uncert"][0], 3.0, device=device)]
    return {"table": table, "decoder": dec, "uncert": unc}


def program_tree(cfg: dict, leaves: Dict[str, List[torch.Tensor]]) -> dict:
    """The leaves as the program's params tree of host arrays (its
    ``Mapper.load_weights`` input)."""
    def host(t):
        return t.detach().float().cpu().numpy()

    table = [host(t) for t in leaves["table"]]
    n_sdf = cfg["decoder"]["num_layers"]
    dec = [host(t) for t in leaves["decoder"]]
    tree = {"table": ({"hash": table[0], "dense": table[1:]}
                      if cfg["grid"]["layout"] == "hybrid" else table[0]),
            "sdf_mlp": dec[:n_sdf], "color_mlp": dec[n_sdf:]}
    if cfg["decoder"]["uncert_grid"]:
        tree["uncert_grid"] = host(leaves["uncert"][0])
    return tree
