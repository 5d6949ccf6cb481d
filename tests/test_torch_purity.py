"""The PyTorch port stands alone: no module of src/repro_torch/ or
examples_torch/ and not chip_smoke.py imports jax, jaxlib or the JAX
package `repro`."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in (os.path.join(ROOT, "src", "repro_torch"),
                os.path.join(ROOT, "examples_torch")):
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            files += [os.path.join(dirpath, f) for f in sorted(filenames)
                      if f.endswith(".py")]
    return files


def _imported_roots(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert os.path.exists(files[0])
    assert len(files) > 20
    examples = {os.path.basename(f) for f in files
                if os.path.basename(os.path.dirname(f)) == "examples_torch"}
    assert {"quickstart.py", "serve_batched.py", "long_context_decode.py",
            "train_mlm.py"} <= examples


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_checker_sees_forbidden_imports(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import jax.numpy as jnp\nfrom repro.core import cache\n"
                 "import repro_torch\nimportlib.import_module('repro.x')\n")
    assert [m for _, m in _imported_roots(str(p))] == \
        ["jax", "repro", "repro_torch", "repro"]
