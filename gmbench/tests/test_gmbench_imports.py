"""Nothing of the benchmark loads JAX or the JAX package (top-level names
compared whole: ``green_marl_tpu_torch`` begins with ``green_marl_tpu``),
and the references load nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from gmbench import spec
from gmbench.run import FORBIDDEN

PROGRAM = "green_marl_tpu_torch"


def _loaded_after(imports):
    code = ("import importlib, json, sys\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=300, check=True)
    return set(json.loads(p.stdout.splitlines()[-1]))


def _modules(folder=""):
    base = spec.PKG / folder if folder else spec.PKG
    return sorted(p for p in base.rglob("*.py") if "tests" not in p.parts)


def test_no_module_of_the_benchmark_loads_jax():
    names = [".".join(p.relative_to(spec.ROOT).with_suffix("").parts)
             for p in _modules()]
    names = [n[:-len(".__init__")] if n.endswith(".__init__") else n
             for n in names]
    loaded = _loaded_after(names)
    assert PROGRAM in loaded       # the program is what they drive
    assert not loaded & set(FORBIDDEN)


def test_references_load_nothing_of_the_program():
    names = ["gmbench.reference"] + [
        f"gmbench.reference.{p.stem}" for p in _modules("reference")
        if p.stem != "__init__"]
    loaded = _loaded_after(names)
    assert PROGRAM not in loaded and not loaded & set(FORBIDDEN)


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.name)
def test_no_import_statement_names_jax(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & set(FORBIDDEN)
    if "reference" in path.parts:
        assert PROGRAM not in tops


def test_forbidden_names_compare_whole(monkeypatch):
    from gmbench import run
    monkeypatch.setitem(sys.modules, "green_marl_tpu_torchlike", sys)
    assert "green_marl_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "green_marl_tpu.x", sys)
    assert "green_marl_tpu" in run.loaded_forbidden()
