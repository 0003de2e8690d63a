"""Versioned, pickle-free checkpoints (npz + JSON header), written and read
without jax: the port's counterpart of naruto_tpu/utils/ckpt_io.py, in the
same format, so a checkpoint either package writes loads in the other.

A checkpoint is a plain .npz zip: one array per tree leaf, keyed by its tree
path (``leaf:['params']['sdf_mlp'][0]``, jax's ``keystr``), plus a
``__meta__`` JSON string with ``format_version``, the tree's structure
string and caller metadata (step, grid layout). Trees are nested dicts,
lists, tuples and NamedTuples (``named_node``) of tensors or arrays. The
structure string is the one ``str(jax.tree_util.tree_structure(tree))``
gives for such a tree, e.g. ``PyTreeDef({'params': {'sdf_mlp': [*, *],
'table': {'hash': *}}, 'poses': *})``: dict keys sorted, lists ``[...]``,
tuples ``(...)``, a NamedTuple ``CustomNode(namedtuple[Name], [...])``
with its fields in declaration order (path pieces ``.field``), leaves
``*``. Leaves are flattened in that order too. The full-state snapshot's
tree is the JAX package's ``MapperState``, whose optimizer states and
keyframe store are NamedTuples (``EmbedAdamState``, optax's
``ScaleByAdamState`` and ``EmptyState``, ``KeyframeDB``).

Loading never unpickles: ``load_tree`` re-attaches the leaves to a live
template after checking the structure string and the leaf set, so layout
drift is a clear error.
"""
from __future__ import annotations

import collections
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1
_LEAF = "leaf:"
_ZIP_MAGIC = b"PK\x03\x04"
_NAMED: Dict[Tuple[str, Tuple[str, ...]], type] = {}


def named_node(name: str, **fields) -> tuple:
    """A NamedTuple tree node of class `name` with `fields` in order: it
    flattens and fingerprints as the JAX package's NamedTuple of that name
    does."""
    key = (name, tuple(fields))
    if key not in _NAMED:
        _NAMED[key] = collections.namedtuple(name, key[1])
    return _NAMED[key](**fields)


def _is_named(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(path piece, child) of an inner node in flatten order; None for a
    leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_named(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_keys(tree: Any) -> List[Tuple[str, Any]]:
    """[(keystr path, leaf)] in jax's flatten order."""
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    return [(piece + path, leaf) for piece, child in kids
            for path, leaf in flatten_with_keys(child)]


def _structure(node) -> str:
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_structure(v) for v in node) + "]"
    if _is_named(node):
        inner = ", ".join(_structure(v) for v in node)
        return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
    if isinstance(node, tuple):
        inner = ", ".join(_structure(v) for v in node)
        return f"({inner},)" if len(node) == 1 else f"({inner})"
    return "*"


def treedef_fingerprint(tree: Any) -> str:
    """The string of ``jax.tree_util.tree_structure(tree)``."""
    return f"PyTreeDef({_structure(tree)})"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_tree(path: str, tree: Any, meta: Optional[Dict] = None) -> None:
    """Write `tree`'s leaves + a versioned JSON header to `path` (npz)."""
    flat = flatten_with_keys(tree)
    header = dict(meta or {})
    header["format_version"] = FORMAT_VERSION
    header["treedef"] = treedef_fingerprint(tree)
    header["n_leaves"] = len(flat)
    arrays = {_LEAF + k: _to_numpy(v) for k, v in flat}
    arrays["__meta__"] = np.frombuffer(json.dumps(header).encode(),
                                       dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # write-then-rename so a crash mid-save never leaves a torn checkpoint
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def is_legacy_pickle(path: str) -> bool:
    """True for a file that is no npz (the JAX package's pre-npz pickle
    snapshots, which this package never unpickles)."""
    with open(path, "rb") as f:
        return f.read(4) != _ZIP_MAGIC


def _read_meta(z) -> Dict:
    header = json.loads(bytes(z["__meta__"].tobytes()).decode())
    if header.get("format_version", 0) > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint format_version {header['format_version']} is "
            f"newer than this build ({FORMAT_VERSION})")
    return header


def _unflatten(template: Any, leaves: List[np.ndarray]) -> Any:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_named(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


def load_tree(path: str, template: Any) -> Tuple[Any, Dict]:
    """Load leaves (numpy arrays) from `path` onto `template`'s structure.

    Returns (tree, meta). Raises ValueError when the checkpoint's structure
    string or leaf set differs from the template's."""
    with np.load(path, allow_pickle=False) as z:
        header = _read_meta(z)
        want_fp = treedef_fingerprint(template)
        got_fp = header.get("treedef", "")
        if got_fp != want_fp:
            raise ValueError(
                "checkpoint tree structure differs from this build "
                f"(ckpt {got_fp!r} vs configured {want_fp!r}) — likely "
                "saved under a different grid.layout; match the writing "
                "config")
        want_keys = [_LEAF + k for k, _ in flatten_with_keys(template)]
        have = set(k for k in z.files if k.startswith(_LEAF))
        missing = [k for k in want_keys if k not in have]
        extra = sorted(have - set(want_keys))
        if missing or extra:
            raise ValueError(f"checkpoint leaf set differs: missing "
                             f"{missing[:4]}, extra {extra[:4]}")
        leaves = [z[k] for k in want_keys]
    return _unflatten(template, leaves), header


def load_arrays(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Template-free read: ({tree path: array}, header)."""
    with np.load(path, allow_pickle=False) as z:
        header = _read_meta(z)
        out = {k[len(_LEAF):]: z[k] for k in z.files if k.startswith(_LEAF)}
    return out, header


def to_torch(tree: Any, device="cpu") -> Any:
    """The same tree with every leaf an f32 tensor on `device`."""
    kids = _children(tree)
    if kids is None:
        return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return [to_torch(v, device) for v in tree]
