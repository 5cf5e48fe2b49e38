"""Nothing under port_bench/ imports JAX, flax or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``), and the reference
imports nothing of the port."""
import ast

import pytest

from port_bench_tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in (ROOT / "port_bench").rglob("*.py") if "__pycache__" not in p.parts)


def imported(path):
    """Top-level names of every module a file imports (relative imports aside)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "port_bench/reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "repro_torch" not in names and not names & FORBIDDEN
    # within the benchmark it reads only the configuration arithmetic
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("port_"):
            assert node.module in ("port_bench.archcfg", "port_bench.reference")


def test_the_scan_sees_imports(tmp_path):
    tree = "import jax.numpy as jnp\nfrom repro.core import x\nimport repro_torch\n"
    path = tmp_path / "probe.py"
    path.write_text(tree)
    assert imported(path) == {"jax", "repro", "repro_torch"}
