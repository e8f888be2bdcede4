"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name is
compared whole (``refinedet_tpu_torch`` begins with ``refinedet_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "refinedet_tpu"}
PORT = "refinedet_tpu_torch"


def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax(path):
    assert not set(imported(path)) & FORBIDDEN


REFERENCE = sorted((BENCH / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(imported(path))


def test_the_run_check_compares_whole_names(monkeypatch):
    import sys
    import types

    from portbench.harness import forbidden_modules
    monkeypatch.setitem(sys.modules, "refinedet_tpu_torch_x",
                        types.ModuleType("refinedet_tpu_torch_x"))
    monkeypatch.setitem(sys.modules, "refinedet_tpu_torch.y",
                        types.ModuleType("refinedet_tpu_torch.y"))
    before = forbidden_modules()
    assert not [m for m in before if m.startswith("refinedet_tpu_torch")]
    monkeypatch.setitem(sys.modules, "refinedet_tpu.models",
                        types.ModuleType("refinedet_tpu.models"))
    assert "refinedet_tpu.models" in forbidden_modules()
