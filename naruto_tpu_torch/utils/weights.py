"""Carry field weights from the JAX package into the port (counterpart of
naruto_tpu/utils/ckpt_io.py, read side only).

A JAX checkpoint (``Mapper.save_ckpt``) is an npz with one array per pytree
leaf, keyed by its tree path, e.g. ``leaf:['params']['table']['hash']`` or
``leaf:['params']['sdf_mlp'][0]``, plus a ``__meta__`` JSON header. It is
read here with numpy alone. The port's params are plain dicts and lists of
tensors with the same structure, so the path gives the place directly.
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
_LEAF = "leaf:"
_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _parse_path(path: str) -> list:
    keys = []
    pos = 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"unreadable checkpoint leaf path {path!r}")
        keys.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"unreadable checkpoint leaf path {path!r}")
    return keys


def _insert(tree: dict, keys: list, value) -> None:
    """Nested dicts keyed by the path (list indices stay int keys here)."""
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _lists_from_int_keys(node):
    """{0: a, 1: b} -> [a, b] (list leaves were keyed by index)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists_from_int_keys(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        if sorted(out) != list(range(len(out))):
            raise ValueError(f"list indices {sorted(out)} are not 0..n-1")
        return [out[i] for i in range(len(out))]
    return out


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict]:
    """npz checkpoint -> (nested dict/list tree of numpy arrays, meta)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(f"checkpoint format_version "
                             f"{meta['format_version']} is newer than "
                             f"{FORMAT_VERSION}")
        tree: dict = {}
        for k in z.files:
            if k.startswith(_LEAF):
                _insert(tree, _parse_path(k[len(_LEAF):]), z[k])
    return _lists_from_int_keys(tree), meta


def _to_torch(node, device):
    if isinstance(node, dict):
        return {k: _to_torch(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, device) for v in node]
    return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)


def load_jax_params(src, device="cpu") -> Dict[str, Any]:
    """Field params for the port from a JAX checkpoint path or from an
    in-memory pytree of numpy arrays (either the params tree itself or a
    tree holding it under "params"). Returns dicts/lists of f32 tensors."""
    tree = read_jax_checkpoint(src)[0] if isinstance(src, str) else src
    if "params" in tree:
        tree = tree["params"]
    return _to_torch(tree, device)
