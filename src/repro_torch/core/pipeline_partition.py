"""Pipeline-stage partitioning via the paper's DAG scheduler.

Partitioning a layer chain into ``p`` pipeline stages *is* the ACETONE
problem with ``p`` workers under a precedence chain: minimize the bottleneck
stage (steady-state throughput) subject to contiguity.  We provide

* :func:`chain_partition` — optimal contiguous partition of a layer chain by
  bottleneck cost (classic DP, the "chain-on-chains" specialization); the
  edge costs enter as inter-stage activation-transfer terms exactly like the
  paper's ``w(e)``;
* :func:`dag_partition` — general (branchy) graphs: run ISH/DSH on the full
  DAG with ``p`` workers, then read stage assignment off the sub-schedules
  (the paper's schedule *is* the stage map).

Both return a :class:`PipelinePlan` with per-stage cost and the steady-state
bubble fraction for ``m`` microbatches (1F1B-style: bubble = (p-1)/(m+p-1)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import DAG
from repro_torch.core.list_scheduling import dsh, ish

__all__ = ["PipelinePlan", "chain_partition", "dag_partition"]


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    n_stages: int
    stages: Tuple[Tuple[str, ...], ...]   # node names per stage, in order
    stage_cost: Tuple[float, ...]         # compute per stage
    boundary_comm: Tuple[float, ...]      # w(e) across each stage boundary
    bottleneck: float

    def bubble_fraction(self, n_microbatches: int) -> float:
        p = self.n_stages
        return (p - 1) / max(n_microbatches + p - 1, 1)

    def steady_state_step_time(self, n_microbatches: int) -> float:
        """Per-(global)batch time: m bottleneck slots + pipeline fill."""
        fill = sum(self.stage_cost) + sum(self.boundary_comm)
        return (n_microbatches - 1) * self.bottleneck + fill


def chain_partition(
    costs: Sequence[float],
    p: int,
    names: Optional[Sequence[str]] = None,
    edge_comm: Optional[Sequence[float]] = None,
) -> PipelinePlan:
    """Optimal contiguous p-way partition minimizing the bottleneck stage.

    ``costs[i]`` is layer i's time; ``edge_comm[i]`` the transfer cost of the
    activation crossing a cut between layer i and i+1 (charged to the
    *receiving* stage, matching the paper's Reading-operator accounting).
    DP over (layer, stage): O(n² p).
    """
    n = len(costs)
    if names is None:
        names = [f"L{i}" for i in range(n)]
    if edge_comm is None:
        edge_comm = [0.0] * (n - 1)
    p = min(p, n)
    INF = float("inf")
    pref = [0.0]
    for c in costs:
        pref.append(pref[-1] + c)

    def seg(i: int, j: int) -> float:  # cost of layers [i, j)
        base = pref[j] - pref[i]
        recv = edge_comm[i - 1] if i > 0 else 0.0
        return base + recv

    # dp[k][j]: min bottleneck splitting first j layers into k stages
    dp = [[INF] * (n + 1) for _ in range(p + 1)]
    cut = [[0] * (n + 1) for _ in range(p + 1)]
    dp[0][0] = 0.0
    for k in range(1, p + 1):
        for j in range(1, n + 1):
            for i in range(k - 1, j):
                v = max(dp[k - 1][i], seg(i, j))
                if v < dp[k][j] - 1e-12:
                    dp[k][j] = v
                    cut[k][j] = i
    # backtrack
    bounds = [n]
    j = n
    for k in range(p, 0, -1):
        j = cut[k][j]
        bounds.append(j)
    bounds = bounds[::-1]
    stages, scost, bcomm = [], [], []
    for s in range(p):
        i, j = bounds[s], bounds[s + 1]
        stages.append(tuple(names[i:j]))
        scost.append(pref[j] - pref[i])
        if s > 0:
            bcomm.append(edge_comm[bounds[s] - 1])
    return PipelinePlan(
        n_stages=p,
        stages=tuple(stages),
        stage_cost=tuple(scost),
        boundary_comm=tuple(bcomm),
        bottleneck=dp[p][n],
    )


def dag_partition(dag: DAG, p: int, heuristic: str = "dsh") -> PipelinePlan:
    """Stage map for a general DAG: schedule on p workers, stages = workers.

    The worker index ordered by first-start-time becomes the stage index —
    for chain-like graphs this reduces to a contiguous partition; for branchy
    graphs parallel branches land in the same stage wave, which is the
    paper's §5 behaviour.
    """
    fn = {"ish": ish, "dsh": dsh}[heuristic]
    sched = fn(dag, p)
    order = []
    for w in range(sched.n_workers):
        sub = sched.sub_schedule(w)
        if sub:
            order.append((min(i.start for i in sub), w, tuple(i.node for i in sub)))
    order.sort()
    stages = tuple(nodes for (_s, _w, nodes) in order)
    scost = tuple(sum(dag.t[n] for n in nodes) for nodes in stages)
    # boundary comm: sum of edge weights crossing consecutive stages.
    # One pass over the edges with a node->stage index instead of a
    # per-boundary rescan of dag.w.
    # (a DSH-duplicated node can sit in several stages, so the index maps
    # node -> all its stages)
    stage_of: Dict[str, List[int]] = {}
    for si, nodes in enumerate(stages):
        for n in nodes:
            stage_of.setdefault(n, []).append(si)
    bcomm = [0.0] * max(len(stages) - 1, 0)
    for (u, v), w in dag.w.items():
        for su in stage_of[u]:
            if su + 1 < len(stages) and su + 1 in stage_of[v]:
                bcomm[su] += w
    return PipelinePlan(
        n_stages=len(stages),
        stages=stages,
        stage_cost=scost,
        boundary_comm=tuple(bcomm),
        bottleneck=max(scost) if scost else 0.0,
    )
