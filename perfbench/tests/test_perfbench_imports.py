"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and the reference side imports nothing of the port."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: the reference, the comparison, the data and the counts
YARDSTICK = ("reference.py", "check.py", "data.py", "work_count.py")


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_nor_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", YARDSTICK)
def test_reference_side_imports_nothing_of_the_port(name):
    tops = _imports(HERE / name)
    assert "repro_torch" not in tops and not tops & FORBIDDEN


def test_top_level_names_compared_whole():
    from perfbench import harness
    assert "repro_torch" not in harness.FORBIDDEN
    assert "repro" in harness.FORBIDDEN
