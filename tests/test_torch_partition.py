"""The port's copy of ``core/pipeline_partition.py`` against the reference's:
the partition scenarios of ``tests/test_partition_placement.py`` (and a few
larger ones) run on both packages, and the plans are equal field by field
(the two share the scheduler's text, so nothing is approximate).  The copy
is held verbatim in ``tests/test_torch_imports.py``."""
import dataclasses

import pytest

from repro.core import graph as jax_graph
from repro.core import pipeline_partition as jax_partition
from repro_torch.core import graph
from repro_torch.core import pipeline_partition as partition
from repro_torch.core.pipeline_partition import chain_partition, dag_partition


def _same(ours, ref):
    assert type(ours).__name__ == type(ref).__name__ == "PipelinePlan"
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


class TestChainPartition:
    """``tests/test_partition_placement.py::TestChainPartition`` on the port."""

    def test_balanced_uniform_chain(self):
        plan = chain_partition([1.0] * 8, 4)
        assert plan.n_stages == 4
        assert plan.stage_cost == (2.0, 2.0, 2.0, 2.0)
        assert plan.bottleneck == 2.0

    def test_skewed_chain(self):
        plan = chain_partition([1, 1, 10, 1, 1], 3)
        assert plan.bottleneck == 10
        assert ("L2",) in plan.stages

    def test_contiguity_and_coverage(self):
        plan = chain_partition([3, 1, 4, 1, 5, 9, 2, 6], 3)
        assert [n for st in plan.stages for n in st] == [f"L{i}" for i in range(8)]

    def test_edge_comm_charged(self):
        p = chain_partition([4, 4, 4, 4], 2, edge_comm=[0, 100, 0])
        assert 100 not in p.boundary_comm
        assert p.bottleneck == 12
        assert chain_partition([4, 4, 4, 4], 2, edge_comm=[0, 0, 0]).bottleneck == 8

    def test_more_stages_than_layers(self):
        assert chain_partition([1, 2], 5).n_stages == 2

    def test_bubble_fraction(self):
        plan = chain_partition([1] * 4, 4)
        assert plan.bubble_fraction(12) == pytest.approx(3 / 15)
        assert plan.bubble_fraction(1) == pytest.approx(3 / 4)


CHAINS = {
    "uniform": ([1.0] * 8, 4, None, None),
    "skewed": ([1, 1, 10, 1, 1], 3, None, None),
    "mixed": ([3, 1, 4, 1, 5, 9, 2, 6], 3, None, None),
    "edge comm": ([4, 4, 4, 4], 2, None, [0, 100, 0]),
    "named, comm": ([2.5, 0.5, 3.0, 1.0, 4.0, 0.25], 4, list("abcdef"), [1, 0, 2, 0.5, 3]),
    "more stages than layers": ([1, 2], 5, None, None),
    "one stage": ([5, 3, 2], 1, None, None),
}


@pytest.mark.parametrize("case", CHAINS, ids=list(CHAINS))
def test_chain_plans_equal_reference(case):
    costs, p, names, comm = CHAINS[case]
    ours = chain_partition(costs, p, names=names, edge_comm=comm)
    ref = jax_partition.chain_partition(costs, p, names=names, edge_comm=comm)
    _same(ours, ref)
    for m in (1, 4, 12):
        assert ours.bubble_fraction(m) == ref.bubble_fraction(m)
        assert ours.steady_state_step_time(m) == ref.steady_state_step_time(m)


def _branchy(pkg):
    return pkg.DAG.build(["in", "a", "b", "out"],
                         [("in", "a"), ("in", "b"), ("a", "out"), ("b", "out")],
                         {"in": 1, "a": 5, "b": 5, "out": 1}, default_w=0.1)


def test_branchy_dag_partition():
    """``TestDagPartition.test_branchy_graph`` on the port."""
    plan = dag_partition(_branchy(graph), 2)
    assert plan.n_stages <= 2
    assert sum(plan.stage_cost) >= 12


@pytest.mark.parametrize("heuristic", ["dsh", "ish"])
@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_dag_plans_equal_reference(heuristic, p, seed):
    """The branchy graph and random DAGs (``random_dag``, the same seed in
    both packages), staged by ISH and DSH on p workers."""
    _same(dag_partition(_branchy(graph), p, heuristic),
          jax_partition.dag_partition(_branchy(jax_graph), p, heuristic))
    ours = graph.random_dag(24, 0.2, seed=seed)
    ref = jax_graph.random_dag(24, 0.2, seed=seed)
    assert ours.t == ref.t and ours.w == ref.w
    _same(dag_partition(ours, p, heuristic), jax_partition.dag_partition(ref, p, heuristic))


def test_module_exports_equal_reference():
    assert partition.__all__ == jax_partition.__all__
