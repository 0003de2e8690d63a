"""Minimal glTF 2.0 / GLB mesh reader — no external dependencies (the
port's own copy of naruto_tpu/mesh/gltf.py, numpy and the port's image
codec).

MP3D and the custom NARUTO scenes ship as .glb in the reference's habitat
pipeline (the reference's src/simulator/habitat_utils.py:182-215,
scripts/installation); this reader feeds those assets to the C++ BVH
raycaster (sim/raycast.py) as merged (verts, faces, per-vertex colors):

  * binary .glb (JSON + BIN chunks) and .gltf with external/data-URI buffers
  * all mesh primitives of the default scene, node transforms baked in
    (matrix or TRS), TRIANGLES topology
  * vertex colors from COLOR_0 (float / normalized ubyte/ushort)
  * textured materials: the base-color texture is sampled at each vertex's
    TEXCOORD_0 and baked to per-vertex colors (the raycaster interpolates
    vertex colors across triangles — adequate for rgb-loss supervision);
    PNG and baseline JPEG textures decode through the port's own codec
    (utils/image_io.py; ``decode_png`` is its PNG reader), so no imaging
    library is needed. A format the codec does not read (progressive
    JPEG, WebP, ...) falls back to the material baseColorFactor with a
    warning, as the JAX package does for what it cannot decode
  * sparse accessors, byte-stride interleaving
"""
from __future__ import annotations

import base64
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from naruto_tpu_torch.utils import image_io

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}


# ---------------------------------------------------------------- textures
def _rgb_float(img: np.ndarray) -> np.ndarray:
    """A decoded image -> [H, W, 3] float32 in [0, 1] (gray replicated,
    alpha dropped)."""
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    return image_io.as_rgb(img).astype(np.float32) / np.float32(scale)


def decode_png(data: bytes) -> np.ndarray:
    """Decode a PNG (the codec's reader: gray/RGB/RGBA/palette, 8 or 16
    bits) to [H, W, 3] float32 in [0, 1]."""
    return _rgb_float(image_io.decode_png(data))


# -------------------------------------------------------------------- glTF
def _read_buffers(gltf: Dict, bin_chunk: Optional[bytes],
                  base_dir: str) -> List[bytes]:
    out = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            out.append(bin_chunk or b"")
        elif uri.startswith("data:"):
            out.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                out.append(f.read())
    return out


def _accessor(gltf: Dict, buffers: List[bytes], idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    n = acc["count"]
    ncomp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" in acc:
        bv = gltf["bufferViews"][acc["bufferView"]]
        data = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(data, dtype, count=n * ncomp,
                                offset=start).reshape(n, ncomp)
        else:
            raw = np.frombuffer(data, np.uint8)
            rows = np.stack([raw[start + i * stride:
                                 start + i * stride + itemsize]
                             for i in range(n)])
            arr = rows.view(dtype).reshape(n, ncomp)
        arr = arr.copy()
    else:
        arr = np.zeros((n, ncomp), dtype=dtype)

    sparse = acc.get("sparse")
    if sparse:
        cnt = sparse["count"]
        iv = sparse["indices"]
        bv = gltf["bufferViews"][iv["bufferView"]]
        idt = _COMPONENT_DTYPES[iv["componentType"]]
        sidx = np.frombuffer(buffers[bv["buffer"]], idt, count=cnt,
                             offset=bv.get("byteOffset", 0)
                             + iv.get("byteOffset", 0))
        vv = sparse["values"]
        bv = gltf["bufferViews"][vv["bufferView"]]
        svals = np.frombuffer(buffers[bv["buffer"]], dtype, count=cnt * ncomp,
                              offset=bv.get("byteOffset", 0)
                              + vv.get("byteOffset", 0)).reshape(cnt, ncomp)
        arr[sidx.astype(np.int64)] = svals

    if acc.get("normalized") and np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.float32) / np.iinfo(dtype).max
    return arr


def _node_transform(node: Dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m[:3, :3] = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ], np.float32)
    if "scale" in node:
        m[:3, :3] = m[:3, :3] * np.asarray(node["scale"], np.float32)[None, :]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _texture_image(gltf: Dict, buffers: List[bytes], base_dir: str,
                   tex_index: int) -> Optional[np.ndarray]:
    """The base-colour texture decoded, or None where the glTF's reference
    to it is broken or the codec does not read its format (the caller
    falls back). A codec library that fails to build or load raises."""
    try:
        tex = gltf["textures"][tex_index]
        img = gltf["images"][tex["source"]]
        if "bufferView" in img:
            bv = gltf["bufferViews"][img["bufferView"]]
            data = buffers[bv["buffer"]]
            blob = data[bv.get("byteOffset", 0):
                        bv.get("byteOffset", 0) + bv["byteLength"]]
        elif img.get("uri", "").startswith("data:"):
            blob = base64.b64decode(img["uri"].split(",", 1)[1])
        else:
            with open(os.path.join(base_dir, img["uri"]), "rb") as f:
                blob = f.read()
    except (KeyError, IndexError, ValueError, OSError):
        return None      # a broken image reference
    try:
        return _rgb_float(image_io.read_image(blob))
    except (ValueError, IndexError, struct.error, zlib.error):
        return None      # a format the codec does not read, or malformed


def stage_rotation(up, front) -> np.ndarray:
    """Habitat stage-config orientation (MP3D ships one next to each GLB,
    e.g. configs/MP3D/gZ6f7yhEvPG/mp3d.stage_config.json: {"up": [0,1,0],
    "front": [0,0,-1]}): the asset is rotated so `up` maps to +Y and
    `front` to -Z, habitat's canonical frame. The MP3D values are the
    canonical frame itself (identity); a Z-up scan would declare
    up=[0,0,1] and get rotated onto Y-up so real assets work untouched.

    Returns the 3x3 rotation (f32). `front` is re-orthogonalized against
    `up` (habitat tolerates slightly off-axis metadata)."""
    u = np.asarray(up, np.float64)
    u = u / np.linalg.norm(u)
    f = np.asarray(front, np.float64)
    f = f - u * (f @ u)            # project out any up component
    f = f / np.linalg.norm(f)
    r = np.cross(f, u)             # canonical: cross(-Z, +Y) == +X
    src = np.stack([r, u, f], axis=1)                 # columns r,u,f
    tgt = np.stack([[1.0, 0.0, 0.0],
                    [0.0, 1.0, 0.0],
                    [0.0, 0.0, -1.0]], axis=1)        # columns X,Y,-Z
    return (tgt @ src.T).astype(np.float32)


def load_gltf(path: str, quiet: bool = False, up=None, front=None
              ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Load a .glb/.gltf scene -> (verts [N,3] f32, faces [M,3] i32,
    colors [N,3] f32 in [0,1] or None). All primitives merged with node
    transforms applied. `up`/`front` apply a habitat stage-config
    orientation (see stage_rotation); both default to None = identity."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        if head == b"glTF":
            magic, version, _length = struct.unpack("<4sII", f.read(12))
            gltf = None
            bin_chunk = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<I4s", hdr)
                chunk = f.read(clen)
                if ctype == b"JSON":
                    gltf = json.loads(chunk)
                elif ctype == b"BIN\x00":
                    bin_chunk = chunk
            if gltf is None:
                raise ValueError(f"{path}: GLB without JSON chunk")
        else:
            gltf = json.load(open(path))
            bin_chunk = None

    buffers = _read_buffers(gltf, bin_chunk, base_dir)
    nodes = gltf.get("nodes", [])
    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    roots = scene.get("nodes", list(range(len(nodes))))

    all_v: List[np.ndarray] = []
    all_f: List[np.ndarray] = []
    all_c: List[np.ndarray] = []
    any_color = False
    vcount = 0

    def emit(mesh_idx: int, xform: np.ndarray) -> None:
        nonlocal vcount, any_color
        mesh = gltf["meshes"][mesh_idx]
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:      # TRIANGLES only
                continue
            attrs = prim["attributes"]
            v = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
            v = v @ xform[:3, :3].T + xform[:3, 3]
            if "indices" in prim:
                fidx = _accessor(gltf, buffers, prim["indices"])
                fidx = fidx.reshape(-1, 3).astype(np.int64)
            else:
                fidx = np.arange(len(v), dtype=np.int64).reshape(-1, 3)

            col = None
            if "COLOR_0" in attrs:
                col = _accessor(gltf, buffers, attrs["COLOR_0"])
                col = col[:, :3].astype(np.float32)
                if col.max(initial=0.0) > 1.0 + 1e-3:   # un-normalized ints
                    col = col / 255.0
            elif "material" in prim:
                mat = gltf.get("materials", [{}])[prim["material"]]
                pbr = mat.get("pbrMetallicRoughness", {})
                factor = np.asarray(
                    pbr.get("baseColorFactor", [1, 1, 1, 1])[:3], np.float32)
                tex_info = pbr.get("baseColorTexture")
                img = None
                if tex_info is not None and "TEXCOORD_0" in attrs:
                    img = _texture_image(gltf, buffers, base_dir,
                                         tex_info["index"])
                if img is not None:
                    uv = _accessor(gltf, buffers,
                                   attrs["TEXCOORD_0"]).astype(np.float32)
                    hh, ww = img.shape[:2]
                    px = np.clip((uv[:, 0] % 1.0) * (ww - 1), 0,
                                 ww - 1).astype(np.int64)
                    py = np.clip((uv[:, 1] % 1.0) * (hh - 1), 0,
                                 hh - 1).astype(np.int64)
                    col = img[py, px] * factor
                else:
                    if tex_info is not None and not quiet:
                        print(f"| [gltf] | {os.path.basename(path)}: "
                              "texture not decodable (not PNG or baseline "
                              "JPEG) — using baseColorFactor")
                    col = np.tile(factor, (len(v), 1))
            if col is not None:
                any_color = True
            all_v.append(v)
            all_f.append(fidx + vcount)
            all_c.append(col if col is not None
                         else np.full((len(v), 3), 0.7, np.float32))
            vcount += len(v)

    def walk(node_idx: int, parent: np.ndarray) -> None:
        node = nodes[node_idx]
        xform = parent @ _node_transform(node)
        if "mesh" in node:
            emit(node["mesh"], xform)
        for child in node.get("children", []):
            walk(child, parent=xform)

    for r in roots:
        walk(r, np.eye(4, dtype=np.float32))

    if not all_v:
        raise ValueError(f"{path}: no TRIANGLES primitives found")
    verts = np.concatenate(all_v).astype(np.float32)
    faces = np.concatenate(all_f).astype(np.int32)
    colors = np.concatenate(all_c).astype(np.float32) if any_color else None
    if up is not None or front is not None:
        rot = stage_rotation(up if up is not None else [0.0, 1.0, 0.0],
                             front if front is not None else [0.0, 0.0, -1.0])
        verts = verts @ rot.T
    return verts, faces, colors


def write_glb(path: str, verts: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Minimal GLB 2.0 writer: one TRIANGLES primitive with POSITION (+
    COLOR_0 when given, float vec3 in [0,1]) and uint32 indices. Used to
    package synthesized scene meshes as .glb so NARUTO-dataset runs
    exercise the same gltf->raycaster asset path the reference's habitat
    pipeline uses for its custom scenes (habitat_utils.py:182-215)."""
    v = np.ascontiguousarray(verts, dtype=np.float32)
    f = np.ascontiguousarray(faces, dtype=np.uint32)
    blobs = [v.tobytes(), f.tobytes()]
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": len(blobs[0]),
         "target": 34962},
        {"buffer": 0, "byteOffset": len(blobs[0]),
         "byteLength": len(blobs[1]), "target": 34963},
    ]
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": len(v),
         "type": "VEC3", "min": v.min(axis=0).tolist(),
         "max": v.max(axis=0).tolist()},
        {"bufferView": 1, "componentType": 5125, "count": f.size,
         "type": "SCALAR"},
    ]
    attrs = {"POSITION": 0}
    if colors is not None:
        c = np.ascontiguousarray(colors[:, :3], dtype=np.float32)
        off = sum(len(b) for b in blobs)
        blobs.append(c.tobytes())
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(blobs[-1]), "target": 34962})
        accessors.append({"bufferView": 2, "componentType": 5126,
                          "count": len(c), "type": "VEC3"})
        attrs["COLOR_0"] = 2
    bin_chunk = b"".join(blobs)
    bin_chunk += b"\x00" * ((-len(bin_chunk)) % 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "naruto_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": attrs, "indices": 1,
                                    "mode": 4}]}],
        "buffers": [{"byteLength": len(bin_chunk)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    js = json.dumps(gltf, separators=(",", ":")).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_chunk)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sII", b"glTF", 2, total))
        fh.write(struct.pack("<I4s", len(js), b"JSON"))
        fh.write(js)
        fh.write(struct.pack("<I4s", len(bin_chunk), b"BIN\x00"))
        fh.write(bin_chunk)
