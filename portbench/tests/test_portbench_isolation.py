"""The benchmark imports neither JAX nor the JAX package, its references
import nothing of the program, and nothing of it reads the JAX package's
harness (``benchmarks/``)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set[str]:
    """The top-level name (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_there_are_sources():
    assert len(SOURCES) > 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_names_are_compared_whole():
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    assert "repro_torch" not in FORBIDDEN
    tree = ast.parse("import repro_torch.kernels\nfrom repro_torch import x")
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    assert names == {"repro_torch"} and not names & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"repro_torch"})
    assert not {"portbench.program", "portbench.loops"} & {
        n.module for n in ast.walk(ast.parse(path.read_text()))
        if isinstance(n, ast.ImportFrom) and n.module}


@pytest.mark.parametrize("path", [p for p in SOURCES if p != Path(__file__)]
                         + sorted(HERE.rglob("*.json")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_reads_the_jax_harness(path):
    """No string of the benchmark (this test's own aside) names the JAX
    package's harness folder."""
    if path.suffix == ".json":
        assert "benchmarks/" not in path.read_text()
        return
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert "benchmarks" not in node.value.split("/"), path
