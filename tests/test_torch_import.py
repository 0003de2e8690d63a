"""The PyTorch port imports torch and never jax."""
import ast
import pathlib
import subprocess
import sys

PKG = pathlib.Path(__file__).resolve().parents[1] / "naruto_tpu_torch"

JAX_FREE_REUSE = ("naruto_tpu.config", "naruto_tpu.geometry.rays",
                  "naruto_tpu.geometry.voxel", "naruto_tpu.utils.printer")


def test_package_imports_with_jax_blocked():
    """Every module of the port imports in a process where `import jax`
    fails."""
    mods = []
    for p in PKG.rglob("*.py"):
        parts = p.relative_to(PKG).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(("naruto_tpu_torch",) + parts))
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {sorted(mods)!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax.numpy' not in sys.modules\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_source():
    """AST scan: no module of the port names jax, jaxlib or optax, and the
    JAX package is used only through its jax-free modules."""
    bad = []
    for path in PKG.rglob("*.py"):
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "optax"):
                bad.append((path.name, mod))
            elif root == "naruto_tpu" and not mod.startswith(JAX_FREE_REUSE):
                bad.append((path.name, mod))
    assert not bad, bad
