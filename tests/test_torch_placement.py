"""The port's copy of ``core/expert_placement.py`` against the reference's:
the placement cases of ``tests/test_partition_placement.py`` run on both
packages, and the plans are equal field by field (the two share the
scheduler's text, so nothing is approximate).  The copy is held verbatim
in ``tests/test_torch_imports.py``."""
import dataclasses

import pytest

from repro.core import expert_placement as jax_placement
from repro_torch.core import expert_placement as placement
from repro_torch.core.expert_placement import balanced_placement, expert_dag, place_experts

LOADS = {
    "mixed": [3.0, 1.0, 2.0, 5.0, 1.0, 4.0, 2.0, 2.0],
    "hot": [16.0] + [1.0] * 7,
    "shared": [8.0, 1.0, 1.0, 1.0],
    "lpt": [5, 4, 3, 3, 2, 1],
}


def _same(ours, ref):
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


class TestExpertPlacement:
    """``tests/test_partition_placement.py::TestExpertPlacement`` on the port."""

    def test_dag_shape(self):
        d = expert_dag([1.0, 2.0, 3.0])
        assert len(d.nodes) == 5
        assert len(d.sinks()) == 1

    def test_balanced_baseline(self):
        plan = balanced_placement([5, 4, 3, 3, 2, 1], 3)
        assert plan.n_groups == 3
        assert sum(plan.group_load) == pytest.approx(18)
        assert plan.bottleneck <= 7  # LPT bound

    def test_scheduler_placement_covers_all(self):
        loads = [3.0, 1.0, 2.0, 5.0, 1.0, 4.0, 2.0, 2.0]
        plan = place_experts(loads, 4)
        assert set(plan.assignment) == set(range(8))
        assert all(len(g) >= 1 for g in plan.assignment.values())

    def test_skewed_load_beats_naive_spread(self):
        loads = [16.0] + [1.0] * 7
        plan = place_experts(loads, 4)
        naive = max(sum(loads[i::4]) for i in range(4))  # round-robin
        assert plan.bottleneck <= naive + 1e-9

    def test_shared_expert_duplication_semantics(self):
        plan = place_experts([8.0, 1.0, 1.0, 1.0], 2, duplicate_hot=True)
        if plan.duplicated:
            assert plan.bottleneck < 8.0 + 1e-9


@pytest.mark.parametrize("comm", [None, "ones"])
@pytest.mark.parametrize("loads", list(LOADS), ids=str)
def test_expert_dag_equals_reference(loads, comm):
    w = LOADS[loads]
    cpe = None if comm is None else [1.0] * len(w)
    ours = expert_dag(w, dispatch_cost=0.5, combine_cost=0.25, comm_per_expert=cpe)
    ref = jax_placement.expert_dag(w, dispatch_cost=0.5, combine_cost=0.25, comm_per_expert=cpe)
    assert list(ours.nodes) == list(ref.nodes)
    assert sorted(ours.edges) == sorted(ref.edges)
    assert {n: ours.t[n] for n in ours.nodes} == {n: ref.t[n] for n in ref.nodes}


@pytest.mark.parametrize("groups", [2, 3, 4])
@pytest.mark.parametrize("duplicate", [True, False])
@pytest.mark.parametrize("loads", list(LOADS), ids=str)
def test_place_experts_equals_reference(loads, groups, duplicate):
    """The scheduler's placement, duplication of hot and shared experts
    included, is the reference's: assignment, loads, bottleneck."""
    w = [float(x) for x in LOADS[loads]]
    _same(place_experts(w, groups, duplicate_hot=duplicate),
          jax_placement.place_experts(w, groups, duplicate_hot=duplicate))


@pytest.mark.parametrize("groups", [2, 3, 4])
@pytest.mark.parametrize("loads", list(LOADS), ids=str)
def test_balanced_placement_equals_reference(loads, groups):
    _same(balanced_placement(LOADS[loads], groups),
          jax_placement.balanced_placement(LOADS[loads], groups))


def test_placement_plan_lookup():
    plan = place_experts([8.0, 1.0, 1.0, 1.0], 2, duplicate_hot=True)
    assert all(plan.groups_of(e) == plan.assignment[e] for e in range(4))
    assert placement.__all__ == jax_placement.__all__
