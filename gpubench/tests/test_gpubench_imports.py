"""What the benchmark's sources may import and read."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(ROOT.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "ccst_tpu"}


def imported_top_levels(path: pathlib.Path):
    """Top-level names of every module a file imports, whole."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_the_sources_are_found():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    # whole names: ccst_tpu_torch begins with ccst_tpu and is allowed
    assert not set(imported_top_levels(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_port(path):
    assert "ccst_tpu_torch" not in set(imported_top_levels(path))


def test_whole_name_comparison():
    assert "ccst_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name != "tests"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_reads_the_jax_benchmarks(path):
    """No string the code uses (docstrings aside) names the JAX project's
    ``benchmarks/`` folder or ``bench.py``, and nothing imports them."""
    tree = ast.parse(path.read_text(), str(path))
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
                  and n.body and isinstance(n.body[0], ast.Expr)
                  and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docstrings:
            assert "bench.py" not in node.value and not node.value.startswith("benchmarks")
    assert not {"benchmarks", "bench"} & set(imported_top_levels(path))
