"""Nothing under chipbench/ imports JAX or the JAX package ``repro`` (whole
top-level names: ``repro_torch`` begins with ``repro`` and is the program),
nothing reads the JAX benchmarks' folder, and the reference imports nothing
of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_names(path) & FORBIDDEN
    assert "benchmarks/" not in path.read_text() or path.name == Path(__file__).name


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    names = top_names(path)
    assert "repro_torch" not in names
    assert "repro_torch" not in path.read_text()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("chipbench"):
            assert node.module.startswith("chipbench.reference"), node.module


def test_prefix_is_not_a_match(tmp_path):
    """``repro_torch`` and ``reproduce`` are not ``repro``; ``repro.x`` is."""
    probe = tmp_path / "probe.py"
    probe.write_text("import repro_torch.models\nfrom reproduce import x\n")
    assert not top_names(probe) & FORBIDDEN
    probe.write_text("from repro.models import transformer\n")
    assert top_names(probe) & FORBIDDEN == {"repro"}
