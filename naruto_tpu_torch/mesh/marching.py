"""Isosurface extraction: C++ core and a vectorized numpy backend (the
port's own copy of naruto_tpu/mesh/marching.py).

API parity with the reference's `marching_cubes(sdf, isolevel, truncation)`
(NumpyMarchingCubes, used at src/slam/coslam/coslam_utils.py:145): returns
vertices in voxel coordinates + triangle indices; cubes containing any
|value| > truncation (untrusted / unobserved space) produce no faces.

Both backends extract by marching tetrahedra (6 tets per cube around the
0-7 diagonal) — table-free and watertight; see native/marching_tets.cpp.
The default backend is the C++ one, and a failed build raises: on a grid of
millions of voxels the numpy backend is many times slower, so a quiet fall
back would hide the failure as a slow run. ``backend="numpy"`` picks the
numpy backend on purpose.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

BACKENDS = ("native", "numpy")


@functools.lru_cache(maxsize=None)
def _load_lib():
    """The built C++ library, bound with ctypes (built on first use)."""
    from naruto_tpu_torch.native.build import ensure_built

    lib = ctypes.CDLL(ensure_built("marching_tets"))
    lib.marching_tets.restype = ctypes.c_int
    lib.marching_tets.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mt_free.restype = None
    lib.mt_free.argtypes = [ctypes.c_void_p]
    return lib


def marching_cubes(sdf: np.ndarray, isolevel: float = 0.0,
                   truncation: float = 3.0,
                   backend: Optional[str] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """sdf: [X, Y, Z] float. Returns (verts [Nv,3] voxel coords float32,
    faces [Nf,3] int32). backend: None or "native" (the C++ core; raises
    if it does not build), or "numpy"."""
    if backend not in (None, *BACKENDS):
        raise ValueError(f"unknown marching backend {backend!r}; one of "
                         f"{BACKENDS}")
    sdf = np.ascontiguousarray(sdf, dtype=np.float32)
    if backend == "numpy":
        return _marching_tets_numpy(sdf, isolevel, truncation)
    lib = _load_lib()
    vp = ctypes.POINTER(ctypes.c_float)()
    tp = ctypes.POINTER(ctypes.c_int)()
    nv = ctypes.c_int()
    nt = ctypes.c_int()
    rc = lib.marching_tets(
        sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sdf.shape[0], sdf.shape[1], sdf.shape[2],
        ctypes.c_float(isolevel), ctypes.c_float(truncation),
        ctypes.byref(vp), ctypes.byref(tp),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError("marching_tets failed")
    verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy() \
        if nv.value else np.zeros((0, 3), np.float32)
    faces = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy() \
        if nt.value else np.zeros((0, 3), np.int32)
    lib.mt_free(vp)
    lib.mt_free(tp)
    return verts.astype(np.float32), faces.astype(np.int32)


# ------------------------------------------------------------ numpy backend
_TETS = np.array([[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
                  [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64)
_CORNER_OFF = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)], dtype=np.int64)


def _marching_tets_numpy(sdf, isolevel, truncation):
    X, Y, Z = sdf.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = sdf.reshape(-1)
    sx, sy = Y * Z, Z

    # corner global ids for every cube [Ncubes, 8]
    cx, cy, cz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    base = (cx * sx + cy * sy + cz).reshape(-1)
    off = (_CORNER_OFF[:, 0] * sx + _CORNER_OFF[:, 1] * sy
           + _CORNER_OFF[:, 2])
    cid = base[:, None] + off[None, :]                # [N, 8]
    cval = flat[cid]
    keep = np.all(np.abs(cval) <= truncation, axis=1) \
        & np.all(np.isfinite(cval), axis=1)
    cid, cval = cid[keep], cval[keep]
    if cid.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    # expand to tets: [N, 6, 4]
    tg = cid[:, _TETS]                                 # global ids
    tv = cval[:, _TETS]                                # values
    inside = tv < isolevel
    mask = (inside * np.array([1, 2, 4, 8])).sum(-1)   # [N, 6]

    flat_tg = tg.reshape(-1, 4)
    flat_tv = tv.reshape(-1, 4)
    flat_mask = mask.reshape(-1)

    all_tri_vid = []
    # enumerate the 14 non-trivial sign cases
    for case in range(1, 15):
        rows = np.nonzero(flat_mask == case)[0]
        if rows.size == 0:
            continue
        ins = [i for i in range(4) if case & (1 << i)]
        outs = [i for i in range(4) if not case & (1 << i)]
        if len(ins) == 1:
            a = ins[0]
            tris = [[(a, outs[0]), (a, outs[1]), (a, outs[2])]]
        elif len(ins) == 3:
            a = outs[0]
            tris = [[(a, ins[0]), (a, ins[2]), (a, ins[1])]]
        else:
            a, b = ins
            c, d = outs
            tris = [[(a, c), (a, d), (b, d)], [(a, c), (b, d), (b, c)]]
        for tri in tris:
            vid = []
            for (i, j) in tri:
                ga, gb = flat_tg[rows, i], flat_tg[rows, j]
                va, vb = flat_tv[rows, i], flat_tv[rows, j]
                vid.append(_edge_vertex_ids(ga, gb, va, vb, isolevel))
            all_tri_vid.append(np.stack(vid, axis=1))

    if not all_tri_vid:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)

    tri_keys = np.concatenate(all_tri_vid, axis=0)     # [M, 3] edge keys
    # dedup edge keys -> vertex list
    uniq, inv = np.unique(tri_keys.reshape(-1), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate faces
    good = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    faces = faces[good]

    ga = (uniq >> np.uint64(32)).astype(np.int64)
    gb = (uniq & np.uint64(0xFFFFFFFF)).astype(np.int64)
    pa = np.stack([ga // sx, (ga // sy) % Y, ga % Z], -1).astype(np.float64)
    pb = np.stack([gb // sx, (gb // sy) % Y, gb % Z], -1).astype(np.float64)
    va, vb = flat[ga], flat[gb]
    denom = vb - va
    t = np.where(np.abs(denom) < 1e-12, 0.5, (isolevel - va) / denom)
    t = np.clip(t, 0.0, 1.0)[:, None]
    verts = (pa + t * (pb - pa)).astype(np.float32)
    return verts, faces


def _edge_vertex_ids(ga, gb, va, vb, iso):
    lo = np.minimum(ga, gb).astype(np.uint64)
    hi = np.maximum(ga, gb).astype(np.uint64)
    return (lo << np.uint64(32)) | hi
