"""Nothing under gpubench/ imports JAX or the JAX package: every module's
imports are walked with ``ast`` and their top-level names compared whole
(``seekmer_tpu_torch`` is the program and allowed)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "seekmer_tpu"}
SOURCES = sorted(ROOT.rglob("*.py"))


def top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".", 1)[0]


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"run.py", "check.py", "control.py", "world.py"} <= names
    assert len([p for p in SOURCES if p.parent.name == "metrics"]) >= 9


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = sorted(set(top_names(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_walker_sees_forbidden(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\nfrom seekmer_tpu.em import em\n"
                 "import seekmer_tpu_torch\nimport jax.numpy as jnp\n")
    assert set(top_names(p)) & FORBIDDEN == {"seekmer_tpu", "jax"}


def test_run_refuses_forbidden_modules(monkeypatch):
    import sys
    import types

    from gpubench import run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "seekmer_tpu", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "seekmer_tpu_torch.fake",
                        types.ModuleType("y"))
    assert run.forbidden_modules() == ["seekmer_tpu"]
