"""Static multi-worker schedules (paper §2.3).

A schedule is a tuple ``(Sc_1 ... Sc_m)`` of per-worker sub-schedules; each
sub-schedule is a list of ``(node, start_time)`` pairs.  Nodes may be
*duplicated* across workers to elide communication.  Validity (paper §2.3):

  * no two instances overlap on one worker;
  * an instance of ``v`` on worker ``j`` starts only once, for every parent
    edge ``(u, v)``, some instance of ``u`` has finished — plus ``w(u,v)``
    when that instance lives on a different worker (the executor always
    reads from the *best* available instance, matching the improved
    encoding's earliest-finish semantics, constraint (11));
  * every node appears at least once, and at most once per worker.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.graph import DAG

__all__ = ["Instance", "Schedule", "ScheduleError", "validate", "remove_redundant_duplicates"]

EPS = 1e-9


class ScheduleError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Instance:
    """One placed copy of a node."""

    node: str
    worker: int
    start: float

    def finish(self, dag: DAG) -> float:
        return self.start + dag.t[self.node]


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Immutable schedule over ``n_workers`` workers.

    Like :class:`~repro.core.graph.DAG`, per-node and per-worker instance
    indexes are memoized on first use so repeated queries (validation, plan
    construction, availability argmins) don't rescan the instance tuple.
    """

    n_workers: int
    instances: Tuple[Instance, ...]

    def _memo(self, key: str, fn):
        cache = self.__dict__.get("_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_cache", cache)
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    # -------------------------------------------------------------- #
    def by_node(self) -> Dict[str, Tuple[Instance, ...]]:
        """node -> its instances (cached)."""

        def build() -> Dict[str, Tuple[Instance, ...]]:
            m: Dict[str, List[Instance]] = {}
            for i in self.instances:
                m.setdefault(i.node, []).append(i)
            return {k: tuple(v) for k, v in m.items()}

        return self._memo("by_node", build)

    def by_worker(self) -> Dict[int, Tuple[Instance, ...]]:
        """worker -> start-sorted sub-schedule (cached)."""

        def build() -> Dict[int, Tuple[Instance, ...]]:
            m: Dict[int, List[Instance]] = {w: [] for w in range(self.n_workers)}
            for i in self.instances:
                m.setdefault(i.worker, []).append(i)
            return {k: tuple(sorted(v, key=lambda i: i.start)) for k, v in m.items()}

        return self._memo("by_worker", build)

    def sub_schedule(self, worker: int) -> Tuple[Instance, ...]:
        return self.by_worker().get(worker, ())

    def instances_of(self, node: str) -> Tuple[Instance, ...]:
        return self.by_node().get(node, ())

    def makespan(self, dag: DAG) -> float:
        if not self.instances:
            return 0.0
        return max(i.finish(dag) for i in self.instances)

    def workers_used(self) -> int:
        return len({i.worker for i in self.instances})

    def n_duplicates(self, dag: DAG) -> int:
        return len(self.instances) - len(dag.nodes)

    # -------------------------------------------------------------- #
    def earliest_availability(
        self, dag: DAG, node: str, worker: int, consumer: str
    ) -> float:
        """Earliest time ``node``'s output is usable on ``worker`` for the
        edge ``(node, consumer)``.

        ``min`` over instances of ``finish + (0 if same worker else
        w(node, consumer))`` — the executor picks the best source instance
        (improved-encoding earliest-finish semantics, constraint (11)).
        """
        insts = self.instances_of(node)
        if not insts:
            raise ScheduleError(f"node {node} unscheduled")
        we = dag.w[(node, consumer)]
        return min(
            i.finish(dag) + (0.0 if i.worker == worker else we) for i in insts
        )

    def data_ready(self, dag: DAG, node: str, worker: int) -> float:
        """Earliest start time of ``node`` on ``worker`` wrt data only."""
        ready = 0.0
        for u in dag.parents(node):
            ready = max(ready, self.earliest_availability(dag, u, worker, node))
        return ready

    def gantt(self, dag: DAG, width: int = 72) -> str:
        """ASCII Gantt chart (debugging aid)."""
        mk = self.makespan(dag) or 1.0
        lines = []
        for p in range(self.n_workers):
            row = [" "] * width
            for inst in self.sub_schedule(p):
                a = int(inst.start / mk * (width - 1))
                b = max(a + 1, int(inst.finish(dag) / mk * (width - 1)))
                label = inst.node[: b - a]
                for k in range(a, min(b, width)):
                    row[k] = "#"
                row[a : a + len(label)] = label
            lines.append(f"P{p}|" + "".join(row) + "|")
        return "\n".join(lines)


def validate(schedule: Schedule, dag: DAG) -> None:
    """Raise :class:`ScheduleError` unless the schedule is valid (paper §2.3)."""
    seen_nodes = set()
    for inst in schedule.instances:
        if inst.node not in dag.t:
            raise ScheduleError(f"unknown node {inst.node}")
        if not (0 <= inst.worker < schedule.n_workers):
            raise ScheduleError(f"worker {inst.worker} out of range")
        if inst.start < -EPS:
            raise ScheduleError(f"negative start for {inst}")
        seen_nodes.add(inst.node)

    missing = set(dag.nodes) - seen_nodes
    if missing:
        raise ScheduleError(f"nodes never scheduled: {sorted(missing)}")

    # at most once per worker + no overlap on a worker
    for p, insts in schedule.by_worker().items():
        names = [i.node for i in insts]
        if len(names) != len(set(names)):
            raise ScheduleError(f"node duplicated within worker {p}")
        for a, b in zip(insts, insts[1:]):
            if a.finish(dag) > b.start + EPS:
                raise ScheduleError(
                    f"overlap on worker {p}: {a.node}[{a.start},{a.finish(dag)}) vs "
                    f"{b.node}[{b.start},{b.finish(dag)})"
                )

    # precedence + communication
    by_node = schedule.by_node()
    for (u, v) in dag.edges:
        we = dag.w[(u, v)]
        for iv in by_node[v]:
            arrival = min(
                iu.finish(dag) + (0.0 if iu.worker == iv.worker else we)
                for iu in by_node[u]
            )
            if arrival > iv.start + EPS:
                raise ScheduleError(
                    f"precedence violated: {v}@P{iv.worker} starts {iv.start} < "
                    f"arrival {arrival} of {u}"
                )


def remove_redundant_duplicates(schedule: Schedule, dag: DAG) -> Schedule:
    """Drop duplicate instances that supply no consumer (paper §2.3).

    We walk backwards from each sink's best (earliest-finishing) instance,
    marking, for every kept consumer instance and each of its parents, the
    *supplier* instance actually used (the availability argmin).  Unmarked
    instances are redundant and removed.  The result remains valid and has
    an identical makespan contribution for every kept instance.
    """
    by_node = schedule.by_node()
    # (instance, finish) lists per node: the supplier argmin below runs once
    # per kept-instance parent edge, so hoist the finish computation out of it
    with_fin: Dict[str, List[Tuple[Instance, float]]] = {
        n: [(iu, iu.finish(dag)) for iu in insts] for n, insts in by_node.items()
    }

    keep: set = set()
    stack: List[Instance] = []
    for s in dag.sinks():
        best = min(with_fin[s], key=lambda p: p[1])[0]
        keep.add(best)
        stack.append(best)

    parents = dag.parent_map()
    while stack:
        iv = stack.pop()
        ivw = iv.worker
        for u in parents[iv.node]:
            we = dag.w[(u, iv.node)]
            supplier = None
            best_a = float("inf")
            for (iu, f) in with_fin[u]:
                a = f if iu.worker == ivw else f + we
                if a < best_a:  # strict: ties keep the first instance, as min()
                    best_a, supplier = a, iu
            if supplier not in keep:
                keep.add(supplier)
                stack.append(supplier)

    kept = tuple(sorted(keep, key=lambda i: (i.worker, i.start)))
    return Schedule(n_workers=schedule.n_workers, instances=kept)


def single_worker_schedule(dag: DAG) -> Schedule:
    """Sequential baseline: topological order on worker 0."""
    t = 0.0
    insts = []
    for n in dag.topological_order():
        insts.append(Instance(node=n, worker=0, start=t))
        t += dag.t[n]
    return Schedule(n_workers=1, instances=tuple(insts))


def speedup(schedule: Schedule, dag: DAG) -> float:
    """Paper eq. (15): single-worker makespan / schedule makespan."""
    mk = schedule.makespan(dag)
    return dag.sequential_makespan() / mk if mk > 0 else float("inf")
