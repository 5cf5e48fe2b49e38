"""MoE expert -> EP-group placement as the paper's scheduling problem.

Experts are parallel branches of a two-level DAG (router -> experts ->
combine); placing experts on EP groups to minimize the *bottleneck group*
under skewed token loads is the ACETONE DAG problem with ``g`` workers.
The paper's duplication insight maps exactly:

* **shared experts** (deepseek) / the **dense residual** (arctic) are
  branches consumed by *every* token — duplicating them on every group
  (instead of all-to-all'ing their output) is the paper's
  "duplicate-to-elide-communication" move;
* **hot experts** (load skew) can be duplicated onto several groups,
  halving their per-group load at the cost of replicated weights — the same
  time/memory trade the paper's DSH makes.

``place_experts`` uses the list scheduler on the expert DAG;
``balanced_placement`` is the LPT baseline; both return a
:class:`PlacementPlan` with per-group load and the all-to-all bytes the
placement implies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import DAG
from repro_torch.core.list_scheduling import list_schedule

__all__ = ["PlacementPlan", "expert_dag", "place_experts", "balanced_placement"]


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    n_groups: int
    assignment: Dict[int, Tuple[int, ...]]   # expert -> groups (>=1 entries)
    group_load: Tuple[float, ...]
    bottleneck: float
    duplicated: Tuple[int, ...]               # experts placed on >1 group

    def groups_of(self, e: int) -> Tuple[int, ...]:
        return self.assignment[e]


def expert_dag(
    expert_loads: Sequence[float],
    dispatch_cost: float = 0.0,
    combine_cost: float = 0.0,
    comm_per_expert: Optional[Sequence[float]] = None,
) -> DAG:
    """Two-level DAG: dispatch -> expert_i -> combine (one-sink already)."""
    E = len(expert_loads)
    nodes = ["dispatch"] + [f"e{i}" for i in range(E)] + ["combine"]
    edges = []
    w = {}
    comm = comm_per_expert or [0.0] * E
    for i in range(E):
        edges.append(("dispatch", f"e{i}"))
        w[("dispatch", f"e{i}")] = comm[i]
        edges.append((f"e{i}", "combine"))
        w[(f"e{i}", "combine")] = comm[i]
    t = {"dispatch": dispatch_cost, "combine": combine_cost}
    for i, l in enumerate(expert_loads):
        t[f"e{i}"] = float(l)
    return DAG.build(nodes, edges, t, w)


def place_experts(
    expert_loads: Sequence[float],
    n_groups: int,
    duplicate_hot: bool = True,
    comm_per_expert: Optional[Sequence[float]] = None,
) -> PlacementPlan:
    """Schedule the expert DAG on ``n_groups`` workers (ISH/DSH machinery)."""
    dag = expert_dag(expert_loads, comm_per_expert=comm_per_expert)
    sched = list_schedule(dag, n_groups, duplicate=duplicate_hot)
    E = len(expert_loads)
    assignment: Dict[int, List[int]] = {i: [] for i in range(E)}
    for inst in sched.instances:
        if inst.node.startswith("e"):
            try:
                idx = int(inst.node[1:])
            except ValueError:
                continue
            assignment[idx].append(inst.worker)
    # experts whose instances were pruned keep >= 1 group by construction
    loads = [0.0] * n_groups
    for e, gs in assignment.items():
        share = expert_loads[e] / max(len(gs), 1)
        for g in gs:
            loads[g] += share
    dup = tuple(e for e, gs in assignment.items() if len(gs) > 1)
    return PlacementPlan(
        n_groups=n_groups,
        assignment={e: tuple(sorted(gs)) for e, gs in assignment.items()},
        group_load=tuple(loads),
        bottleneck=max(loads) if loads else 0.0,
        duplicated=dup,
    )


def balanced_placement(expert_loads: Sequence[float], n_groups: int) -> PlacementPlan:
    """LPT greedy baseline (no duplication)."""
    order = sorted(range(len(expert_loads)), key=lambda e: -expert_loads[e])
    loads = [0.0] * n_groups
    assignment: Dict[int, Tuple[int, ...]] = {}
    for e in order:
        g = min(range(n_groups), key=lambda g: loads[g])
        loads[g] += expert_loads[e]
        assignment[e] = (g,)
    return PlacementPlan(
        n_groups=n_groups,
        assignment=assignment,
        group_load=tuple(loads),
        bottleneck=max(loads) if loads else 0.0,
        duplicated=(),
    )
