"""The PyTorch port imports torch and nothing of jax or of naruto_tpu."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "naruto_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "naruto_tpu")
# imaging libraries the card machine does not have: the port has its own
# codec and rasteriser
IMAGING = ("cv2", "PIL", "matplotlib", "imageio")


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where `import jax`,
    `import jaxlib`, `import optax` and `import naruto_tpu` all fail."""
    mods = []
    for p in PKG.rglob("*.py"):
        parts = p.relative_to(PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(("naruto_tpu_torch",) + parts))
    assert "naruto_tpu_torch.mapping.pose_opt" in mods
    for new in ("sim.raycast", "sim.rigs", "mesh.gltf", "geometry.erp",
                "geometry.projection", "scripts.make_scene_assets",
                "utils.image_io", "utils.profiling", "sim.replay",
                "sim.scripted", "visualization", "visualization.raster",
                "visualization.saver", "visualization.offline",
                "export_pose", "parallel", "parallel.mesh",
                "parallel.sharded", "parallel.dryrun",
                "scripts.completion_gaps", "scripts.run_protocol",
                "sim.prefetch"):
        assert f"naruto_tpu_torch.{new}" in mods, new
    code = ("import sys\n"
            f"for m in {FORBIDDEN!r}:\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {sorted(mods)!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not [m for m in sys.modules\n"
            "            if m.startswith('naruto_tpu.')]\n"
            "assert 'jax.numpy' not in sys.modules\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_source():
    """AST scan of the port and chip_smoke.py: no import names jax, jaxlib,
    optax or any module of naruto_tpu."""
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append((str(path.relative_to(ROOT)), mod))
    assert not bad, bad


def test_no_naruto_tpu_import_text_in_source():
    """Line scan, which also sees imports inside strings run by exec or a
    subprocess: no line of the port starts an import of naruto_tpu."""
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            words = line.split()
            if len(words) >= 2 and words[0] in ("import", "from") and \
                    words[1].split(".")[0] in FORBIDDEN:
                bad.append(f"{path.relative_to(ROOT)}:{i}: {line.strip()}")
    assert not bad, bad


def test_no_imaging_library_import_in_source():
    """AST scan of the port and chip_smoke.py: no import names cv2, PIL,
    matplotlib or imageio."""
    bad = []
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in IMAGING:
                bad.append((str(path.relative_to(ROOT)), mod))
    assert not bad, bad


# Runs in a process where jax, naruto_tpu and every imaging library fail to
# import (a finder, as chip_smoke.py's BlockImports): the artifact saver
# with both mesh kinds on a passive engine, every offline mode on its
# artifacts, export_pose, a scripted capture and its replay, and a glb
# whose texture is a JPEG.
_CARDLESS_RUN = """
import importlib.abc, os, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked: {name}", name=name)
sys.meta_path.insert(0, Block())
import numpy as np, torch
torch.set_num_threads(1)
from naruto_tpu_torch import export_pose
from naruto_tpu_torch.config import make_config
from naruto_tpu_torch.config.schema import deep_update
from naruto_tpu_torch.mesh.gltf import load_gltf
from naruto_tpu_torch.sim import init_simulator
from naruto_tpu_torch.sim.scripted import run_scripted_simulation
from naruto_tpu_torch.system.engine import Engine
from naruto_tpu_torch.system.pose_loader import load_traj_file
from naruto_tpu_torch.visualization import offline
cfg = make_config("Replica", "office0", num_iter=6, overrides={
    "cam": {"H": 24, "W": 32, "fx": 16.0, "fy": 16.0, "cx": 15.5,
            "cy": 11.5, "far": 3.0},
    "sim": {"pinhole_hw": (24, 32), "erp_hw": (16, 32), "scene_path": TRAJ},
    "grid": {"hash_size": 12},
    "mapper": {"sample": 64, "iters": 2, "first_iters": 4,
               "min_pixels_cur": 8, "act_ray_num_uncert_sample": 16},
    "training": {"n_range_d": 5, "n_samples_d": 8, "smooth_pts": 8},
    "mesh": {"voxel_final": 0.2, "voxel_eval": 0.2},
    "vis": {"enable_all_vis": True, "vis_rgbd": True,
            "save_mesh_voxel_size": 0.2},
    "general": {"result_dir": OUT + "/run", "seed": 0}}).replace(
    enable_active_planning=False)
eng = Engine(cfg, device="cpu", quiet=True)
eng.run()
eng.mapper.save_ckpt(OUT + "/ckpt.pkl")
vis = eng.visualizer.root
for sub in ("color_mesh", "uncert_mesh"):
    assert sorted(os.listdir(os.path.join(vis, sub))) == ["0000.ply",
                                                          "0005.ply"]
offline.main(["traj", "--run", vis, "--out", OUT + "/traj.png"])
for kind in ("color_mesh", "uncert_mesh"):
    offline.main(["mesh_evo", "--run", vis, "--out", OUT + "/" + kind,
                  "--kind", kind])
offline.main(["video", "--run", vis, "--out", OUT + "/v.avi"])
offline.main(["replay", "--run", vis, "--out", OUT + "/rep", "--stride",
              "3", "--video", OUT + "/rep.avi"])
export_pose.main(["--ckpt", OUT + "/ckpt.pkl", "--out", OUT + "/p.npy"])
poses = load_traj_file(TRAJ + "/traj.txt", "Replica")[:3]
run_scripted_simulation(eng.sim, poses, OUT + "/cap", save_video=True)
rep = init_simulator(deep_update(cfg, {"sim": {
    "method": "replay", "scene_path": OUT + "/cap"}}), "cpu")
rep.update_step(2)
assert rep.frame(None)[0].shape == (24, 32, 3)
v, f, c = load_gltf(GLB, quiet=True)
assert c is not None and not np.allclose(c, c[0])
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("ok")
"""


def test_card_paths_run_without_imaging_libraries(tmp_path):
    """The saver, the uncertainty mesh, every offline mode, export_pose,
    scripted capture, replay and a JPEG-textured glb run where cv2, PIL,
    matplotlib and imageio (and jax) cannot be imported, as on the card
    machine."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_jax_gltf_tests_for_import", ROOT / "tests" / "test_gltf.py")
    gltf_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gltf_tests)
    glb = gltf_tests._make_glb(tmp_path, with_texture=True,
                               texture_format="jpeg")
    blocked = FORBIDDEN + IMAGING
    code = (f"BLOCKED = {blocked!r}\nOUT = {str(tmp_path)!r}\n"
            f"TRAJ = {str(ROOT / 'data' / 'traj_ab')!r}\n"
            f"GLB = {str(glb)!r}\n" + _CARDLESS_RUN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
