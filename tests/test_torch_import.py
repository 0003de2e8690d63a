"""The PyTorch port imports torch and nothing of jax or of naruto_tpu."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "naruto_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "naruto_tpu")


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
                "geometry.projection", "scripts.make_scene_assets"):
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
