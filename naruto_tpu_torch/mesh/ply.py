"""Minimal PLY mesh IO (binary little-endian + ascii), no trimesh needed
(the port's own copy of naruto_tpu/mesh/ply.py).

The reference exports meshes through trimesh (coslam_utils.py:212-226) and
evaluates with trimesh loaders; this environment has neither trimesh nor
open3d, so the framework carries its own reader/writer for the same artifact
contract (vertex xyz [+ rgb uchar], triangle faces).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def write_ply(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None,
              binary: bool = True) -> None:
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)

    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {len(verts)}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {len(faces)}",
               "property list uchar int vertex_indices", "end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            if has_color:
                rec = np.zeros(len(verts),
                               dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = verts
                rec["rgb"] = colors
                f.write(rec.tobytes())
            else:
                f.write(verts.astype("<f4").tobytes())
            frec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            frec["n"] = 3
            frec["idx"] = faces
            f.write(frec.tobytes())
        else:
            for i, v in enumerate(verts):
                row = f"{v[0]} {v[1]} {v[2]}"
                if has_color:
                    c = colors[i]
                    row += f" {c[0]} {c[1]} {c[2]}"
                f.write((row + "\n").encode())
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Returns (verts [N,3] f32, faces [M,3] i32, colors [N,3] u8 or None).
    Supports the subset written above plus common ascii/binary_le variants."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header")
    if head_end < 0:
        raise ValueError("not a ply file")
    head_end = data.find(b"\n", head_end) + 1
    header = data[:head_end].decode("ascii", "replace").splitlines()

    fmt = "ascii"
    n_vert = n_face = 0
    vert_props = []
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
            elif cur == "face":
                n_face = int(parts[2])
        elif parts[0] == "property" and cur == "vertex":
            if parts[1] == "list":
                continue
            vert_props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "uint": "<u4",
                "short": "<i2", "ushort": "<u2", "char": "i1"}
    names = [p[0] for p in vert_props]
    has_color = {"red", "green", "blue"} <= set(names)

    if fmt == "ascii":
        text = data[head_end:].decode()
        rows = text.split("\n")
        vvals = np.array([r.split() for r in rows[:n_vert]], dtype=np.float64)
        verts = np.stack([vvals[:, names.index(a)] for a in "xyz"],
                         -1).astype(np.float32)
        colors = None
        if has_color:
            colors = np.stack(
                [vvals[:, names.index(c)] for c in ("red", "green", "blue")],
                -1).astype(np.uint8)
        faces = np.array([r.split()[1:4] for r in rows[n_vert:n_vert + n_face]],
                         dtype=np.int32)
        return verts, faces, colors

    dtype = np.dtype([(n, type_map[t]) for n, t in vert_props])
    body = data[head_end:]
    varr = np.frombuffer(body, dtype=dtype, count=n_vert)
    verts = np.stack([varr[a] for a in "xyz"], -1).astype(np.float32)
    colors = None
    if has_color:
        colors = np.stack([varr[c] for c in ("red", "green", "blue")],
                          -1).astype(np.uint8)
    off = n_vert * dtype.itemsize
    fdtype = np.dtype([("n", "u1"), ("idx", "<i4", 3)])
    farr = np.frombuffer(body, dtype=fdtype, count=n_face, offset=off)
    faces = farr["idx"].astype(np.int32)
    return verts, faces, colors


def read_mesh(path: str):
    """(verts, faces, colors) of a .ply mesh (read_ply, u8 colours) or a
    .glb/.gltf one (load_gltf, f32 colours in [0, 1])."""
    if path.lower().endswith((".glb", ".gltf")):
        from naruto_tpu_torch.mesh.gltf import load_gltf

        return load_gltf(path, quiet=True)
    return read_ply(path)
