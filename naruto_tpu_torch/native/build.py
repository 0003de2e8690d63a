"""Build the port's native C++ extensions with g++ (plain C ABI, bound with
ctypes): the port's own copy of naruto_tpu/native/build.py, for
``marching_tets.cpp`` (mesh extraction), ``raycaster.cpp`` (the raycast
simulator's BVH renderer, a copy of the JAX package's) and
``image_codec.cpp`` (the serial stages of utils/image_io.py: PNG filters,
JPEG Huffman coding and libjpeg's integer transforms).

The library goes into ``naruto_tpu_torch/_build/`` under a name keyed by a
hash of the source and the flags, so a changed source or flag builds anew
and nothing built is tracked. A failed build raises.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"

SOURCES = {"marching_tets": ["marching_tets.cpp"],
           "raycaster": ["raycaster.cpp"],
           "image_codec": ["image_codec.cpp"]}

CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
            "-fopenmp",
            # strict IEEE mul/add (no FMA contraction), as the JAX
            # package's build: both packages' meshes and renders agree bit
            # for bit, and the raycaster's packet, SIMD and scalar paths
            # agree with each other
            "-ffp-contract=off"]


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in SOURCES[name]:
        h.update((NATIVE_DIR / src).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def ensure_built(name: str) -> str:
    """Path of the built library `name`, compiling it first if needed."""
    out = lib_path(name)
    if out.exists():
        return str(out)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build of the
    # same source never loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp),
           *(str(NATIVE_DIR / s) for s in SOURCES[name])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


if __name__ == "__main__":
    for name in SOURCES:
        print(name, "->", ensure_built(name))
