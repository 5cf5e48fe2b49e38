"""The port stands alone: it imports neither JAX nor the JAX package, and
its copies of the reference's configs stay equal to the originals."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.configs as jax_configs
import repro_torch.configs as configs

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.serve.engine, repro_torch.convert, repro_torch.kernels\n"
        "import repro_torch.core, repro_torch.models.cnn, repro_torch.models.slicing\n"
        "import repro_torch.codegen\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_arch_list_equal():
    assert configs.list_archs() == jax_configs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_config_copies_equal_reference(arch):
    ours, ref = configs.get_config(arch), jax_configs.get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
    assert ours.param_count() == ref.param_count()
    assert configs.runnable_cells(ours) == jax_configs.runnable_cells(ref)
