"""The port's glTF reader and writer (mesh/gltf.py) against naruto_tpu's,
on the synthetic assets of tests/test_gltf.py, and the port's scene-asset
script against scripts/make_scene_assets.py."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from naruto_tpu.config import make_config as jmake_config
from naruto_tpu.mesh import gltf as jgltf
from naruto_tpu.sim.raycast import RaycastSimulator as JRaycast
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.mesh import gltf as tgltf
from naruto_tpu_torch.mesh.ply import read_mesh, read_ply
from naruto_tpu_torch.scripts import make_scene_assets as tassets
from naruto_tpu_torch.sim.raycast import RaycastSimulator

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module(rel: str, name: str):
    """A file of the repository loaded as a module (its helpers; no test
    of it is collected from here)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_GLTF_TESTS = _module("tests/test_gltf.py", "_jax_gltf_tests")


def _both(path, **kw):
    return (tgltf.load_gltf(path, quiet=True, **kw),
            jgltf.load_gltf(path, quiet=True, **kw))


def _assert_equal(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["geometry", "png", "jpeg"])
def test_load_gltf_matches_jax(tmp_path, kind):
    """Geometry with vertex colours and node transforms, a PNG-textured
    triangle (the built-in decoder) and a JPEG-textured one (through PIL
    or OpenCV where present, as in the JAX package): equal arrays."""
    path = JAX_GLTF_TESTS._make_glb(
        tmp_path, with_texture=kind != "geometry",
        texture_format="jpeg" if kind == "jpeg" else "png")
    got, want = _both(path)
    _assert_equal(got, want)
    assert got[0].shape == (7, 3)


@pytest.mark.parametrize("fault", ["build", "load"])
def test_texture_codec_failure_raises(tmp_path, monkeypatch, fault):
    """A codec library that fails to build (g++ raising) or to load (not a
    shared object) makes load_gltf raise: no texture falls back quietly."""
    from naruto_tpu_torch.native import build
    from naruto_tpu_torch.utils import image_io

    path = JAX_GLTF_TESTS._make_glb(tmp_path, with_texture=True)
    junk = tmp_path / "not_a_library.so"
    junk.write_bytes(b"not an ELF file")

    def ensure_built(name):
        if fault == "build":
            raise RuntimeError(f"g++ failed to build {name}")
        return str(junk)

    monkeypatch.setattr(image_io, "_LIB", None)
    monkeypatch.setattr(build, "ensure_built", ensure_built)
    with pytest.raises(RuntimeError if fault == "build" else OSError):
        tgltf.load_gltf(path, quiet=True)


def test_undecodable_texture_falls_back(tmp_path, monkeypatch, capsys):
    """A progressive JPEG texture, which the codec refuses, gives the
    material's baseColorFactor (white here) with a warning."""
    import cv2

    img = np.zeros((16, 16, 3), np.uint8)
    img[..., 2] = 255
    ok, jpg = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    assert ok
    # the helper embeds what _png_bytes gives; the codec reads the magic
    monkeypatch.setattr(JAX_GLTF_TESTS, "_png_bytes",
                        lambda _img: jpg.tobytes())
    path = JAX_GLTF_TESTS._make_glb(tmp_path, with_texture=True)
    _, _, colors = tgltf.load_gltf(path)
    np.testing.assert_array_equal(colors[4:], 1.0)
    assert "texture not decodable" in capsys.readouterr().out


def test_decode_png_matches_jax():
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), np.uint8)
    blob = JAX_GLTF_TESTS._png_bytes(img)
    np.testing.assert_array_equal(tgltf.decode_png(blob),
                                  jgltf.decode_png(blob))


@pytest.mark.parametrize("up,front", [([0, 1, 0], [0, 0, -1]),
                                      ([0, 0, 1], [0, 1, 0]),
                                      ([1, 0, 0], [0, 0, 1])])
def test_stage_orientation_matches_jax(tmp_path, up, front):
    """stage_rotation and a glb loaded with up/front equal the JAX
    package's."""
    np.testing.assert_array_equal(tgltf.stage_rotation(up, front),
                                  jgltf.stage_rotation(up, front))
    path = JAX_GLTF_TESTS._make_glb(tmp_path)
    got, want = _both(path, up=up, front=front)
    _assert_equal(got, want)


def test_stage_config_scene_matches_jax(tmp_path):
    """sim.stage_config: the render asset resolved relative to the json,
    oriented by its up/front; the port's raycaster renders what the JAX
    package's does (the quad rotated from z=+2 to y=+2)."""
    path = JAX_GLTF_TESTS._make_glb(tmp_path)
    stage = tmp_path / "scene.stage_config.json"
    stage.write_text(json.dumps({"render_asset": os.path.basename(path),
                                 "up": [0, 0, 1], "front": [0, 1, 0]}))
    over = {"sim": {"method": "raycast", "stage_config": str(stage),
                    "pinhole_hw": (32, 32), "erp_hw": (16, 32)},
            "cam": {"H": 32, "W": 32, "fx": 16.0, "fy": 16.0,
                    "cx": 15.5, "cy": 15.5}}
    t_sim = RaycastSimulator(make_config("Replica", "office0",
                                         overrides=over), "cpu")
    j_sim = JRaycast(jmake_config("Replica", "office0", overrides=over))
    c2w = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0],
                    [0, 0, 0, 1]], np.float32)
    got, want = t_sim.simulate(c2w)[:2], j_sim.simulate(c2w)[:2]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_allclose(got[1].numpy()[14:18, 14:18], 2.0, atol=1e-3)


def test_port_glb_loads_in_jax(tmp_path):
    """A glb the port writes loads in the JAX package's load_gltf as it
    does in the port's, bytes equal to the JAX package's writer's."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
    f = rng.integers(0, 40, (30, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    tp, jp = str(tmp_path / "t.glb"), str(tmp_path / "j.glb")
    tgltf.write_glb(tp, v, f, colors=c)
    jgltf.write_glb(jp, v, f, colors=c)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    got = jgltf.load_gltf(tp, quiet=True)
    np.testing.assert_array_equal(got[0], v)
    np.testing.assert_array_equal(got[1], f)
    np.testing.assert_allclose(got[2], c, atol=1e-6)
    _assert_equal(read_mesh(tp), got)


def test_scene_asset_script_matches_jax(tmp_path, monkeypatch):
    """The port's make_scene_assets against scripts/make_scene_assets.py
    for office0 at voxel 0.1: the same faces, the same vertices (both
    marching-cube the same analytic volume, within 1e-6 of each other) to
    1e-4 m, the same uint8 colours; and the glb form of the CLI."""
    monkeypatch.chdir(tmp_path)
    jscript = _module("scripts/make_scene_assets.py", "_jax_assets")
    monkeypatch.setattr(sys, "argv", ["make_scene_assets.py", "--voxel",
                                      "0.1"])
    jscript.main()
    jv, jf, jc = read_ply(str(tmp_path / "data/Replica/office0/mesh.ply"))
    out = str(tmp_path / "t.ply")
    tassets.main(["--voxel", "0.1", "--device", "cpu", "--out", out])
    tv, tf, tc = read_ply(out)
    np.testing.assert_array_equal(tf, jf)
    assert np.abs(tv - jv).max() <= 1e-4
    np.testing.assert_array_equal(tc, jc)
    glb = str(tmp_path / "t.glb")
    tassets.main(["--voxel", "0.1", "--device", "cpu", "--format", "glb",
                  "--out", glb])
    gv, gf, gc = tgltf.load_gltf(glb, quiet=True)
    np.testing.assert_array_equal(gf, tf)
    np.testing.assert_array_equal(gv, tv)
    np.testing.assert_allclose(gc * 255.0, tc, atol=1e-3)
    with pytest.raises(SystemExit):
        tassets.main(["--device", "cpu", "--format", "glb", "--out", out])
