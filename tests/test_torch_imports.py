"""The port stands alone: no module of rcot_torch/ and not chip_smoke.py
imports JAX (or a JAX library) or anything of rcot_tpu, checked on the
source with `ast`, so that an import inside a function counts too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "rcot_tpu"}
SOURCES = sorted((ROOT / "rcot_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_rcot_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(name, line) for name, line in _imported_roots(tree) if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_sees_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    assert {"rcot_torch/train/steps.py", "rcot_torch/models/critic.py",
            "rcot_torch/ops/block.py", "rcot_torch/ops/fused.py",
            "rcot_torch/train/trainer.py", "rcot_torch/cli/train.py",
            "rcot_torch/utils/checkpoint.py", "rcot_torch/data/pipeline.py",
            "rcot_torch/ops/mdta.py", "rcot_torch/ops/dwconv.py",
            "chip_smoke.py"} <= names
    assert list(_imported_roots(ast.parse("def f():\n    from jax import numpy\n"))) == [
        ("jax", 2)]
