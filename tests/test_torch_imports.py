"""The port stands alone: it imports neither JAX nor the JAX package, its
copies of the reference's configs stay equal to the originals, and the
modules it copies verbatim stay verbatim."""
import ast
import dataclasses
import inspect
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.codegen.executor as jax_executor
import repro.codegen.segment as jax_segment
import repro.configs as jax_configs
import repro.runtime.faults as jax_faults
import repro.serve.frontend as jax_frontend
import repro_torch.codegen.executor as executor
import repro_torch.codegen.segment as segment
import repro_torch.configs as configs
import repro_torch.runtime.faults as faults
import repro_torch.serve.frontend as frontend

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
        "import repro_torch.codegen, repro_torch.codegen.analyze, repro_torch.runtime\n"
        "import repro_torch.serve.frontend, repro_torch.serve.trace\n"
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


# modules of the port that are the reference's text with ``repro`` renamed
VERBATIM = ["codegen/analyze.py", "codegen/validate.py", "codegen/plan.py", "runtime/elastic.py",
            "serve/trace.py"]
# the segmented executor's host tables, copied into the port's executor
HOST_TABLES = ["_waterfill", "PlanTables", "plan_tables", "SegmentAccess", "AccessTables",
               "plan_access_walk", "segment_access_tables"]
# the segmented executor's comm accounting, copied into the port's executor
EXECUTOR_COPIES = HOST_TABLES + ["executed_comm_bytes", "plan_liveness"]
# the host side of codegen/segment.py (its make_kernel is a port)
SEGMENT_COPIES = ["_node_lowering", "node_signature", "node_gather_rows", "param_slices",
                  "SpanTable", "_max_run", "max_sentinel_runs", "resolve_rows", "coalesce_spans"]
# what the port's frontend copies: all but the executor fast path
# (attach_executor, _executor, _exec_run) and the tick's hand-over of its
# rows to the parameters' device (step)
FRONTEND_COPIES = ["FrontendConfig", "ServeRequest", "Backpressure", "ChaosEvent", "ChaosCampaign"]
FRONTEND_METHODS = ["__init__", "now", "fleet", "_service_estimate", "_est", "submit", "_shed",
                    "_shed_expired", "_admit", "_health_check", "_replan", "_active_faults",
                    "_execute", "_recover", "run_trace", "audit", "fingerprint"]
# what the port's fault runner copies (its run_with_faults is a port)
FAULT_COPIES = ["FaultEvent", "FaultPlan", "RunOutcome", "_step_compute_times", "_round_bytes",
                "resume_plan", "_plan_layout", "kill_and_resume_drill"]


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_modules_stay_verbatim(rel):
    port = (REPO / "src" / "repro_torch" / rel).read_text()
    ref = (REPO / "src" / "repro" / rel).read_text()
    assert port.replace("repro_torch", "repro") == ref


@pytest.mark.parametrize("name", EXECUTOR_COPIES)
def test_host_tables_stay_verbatim(name):
    port = inspect.getsource(getattr(executor, name))
    assert port.replace("repro_torch", "repro") == inspect.getsource(getattr(jax_executor, name))


@pytest.mark.parametrize("name", FAULT_COPIES)
def test_fault_runner_copies_stay_verbatim(name):
    port = inspect.getsource(getattr(faults, name))
    assert port.replace("repro_torch", "repro") == inspect.getsource(getattr(jax_faults, name))
    assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS


@pytest.mark.parametrize("name", SEGMENT_COPIES)
def test_segment_host_side_stays_verbatim(name):
    port = inspect.getsource(getattr(segment, name))
    assert port.replace("repro_torch", "repro") == inspect.getsource(getattr(jax_segment, name))


def test_span_thresholds_and_sentinels_equal_reference():
    for name in ("MIN_SPAN", "MAX_SPANS", "MIN_COVERAGE", "ZERO_PAD", "NEGINF_PAD"):
        assert getattr(segment, name) == getattr(jax_segment, name), name


def _stats_block(source: str) -> str:
    """The segment statistics' text: from the comm element counts through
    the end of the ``seg_stats.append`` call."""
    lo = source.index("real_elems = shipped_elems = 0")
    hi = source.index("})", source.index("seg_stats.append({", lo)) + 2
    line_start = source.rindex("\n", 0, lo) + 1
    return textwrap.dedent(source[line_start:hi])


def test_segment_stats_stay_verbatim():
    port = inspect.getsource(executor.SegmentedExecutor.__init__)
    ref = inspect.getsource(jax_executor._build_segmented)
    assert _stats_block(port) == _stats_block(ref)


@pytest.mark.parametrize("name", FRONTEND_COPIES)
def test_frontend_classes_stay_verbatim(name):
    port = inspect.getsource(getattr(frontend, name))
    assert port.replace("repro_torch", "repro") == inspect.getsource(getattr(jax_frontend, name))


def _member_source(cls, name: str) -> str:
    member = inspect.getattr_static(cls, name)
    return inspect.getsource(member.fget if isinstance(member, property) else member)


@pytest.mark.parametrize("name", FRONTEND_METHODS)
def test_frontend_methods_stay_verbatim(name):
    port = _member_source(frontend.Frontend, name)
    assert port.replace("repro_torch", "repro") == _member_source(jax_frontend.Frontend, name)


def test_frontend_step_differs_only_in_the_hand_over():
    port = _member_source(frontend.Frontend, "step")
    ours = """        x = _params_device_tensor(
            np.concatenate([r.x for r in batch], axis=0), self.params
        )
"""
    theirs = "        x = np.concatenate([r.x for r in batch], axis=0)\n"
    assert ours in port
    assert port.replace(ours, theirs) == _member_source(jax_frontend.Frontend, "step")
