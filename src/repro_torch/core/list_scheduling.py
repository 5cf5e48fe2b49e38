"""Critical-path list scheduling heuristics: ISH and DSH (paper §3.3).

Both follow Kruatrachue's framework: every node gets a *level* — the sum of
node execution times along the longest path to the sink — and ready nodes are
kept in a queue ordered by decreasing level.  Repeatedly, the head of the
queue is placed on the worker minimizing its start time.

* **ISH** (Insertion Scheduling Heuristic): if placing the head leaves an
  idle gap on the chosen worker (typically a communication delay), try to
  *insert* lower-level ready nodes into the gap without delaying the head.
* **DSH** (Duplication Scheduling Heuristic): before placing, try to shrink
  the start time by *duplicating* the binding ancestors onto the candidate
  worker (recursively along the binding chain), committing the duplication
  list only when the start time actually improves.

Two drivers share the placement machinery:

* :func:`list_schedule` — the fast path: heap-ordered ready queue with
  incremental indegree tracking (no full-graph ready rescans, no
  re-sorting the queue per placement) and bisect-maintained per-worker
  timelines, O((V+E)·log V·m) up to insertion-step work.
* :func:`list_schedule_reference` — the original O(V²·E) driver, kept as
  the semantics oracle: both drivers visit nodes in the identical
  ``(-level, name)`` order and share placement code, so they produce
  identical schedules (asserted by tests and ``benchmarks/sched_scale.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
from bisect import bisect_left, insort
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.graph import DAG
from repro_torch.core.schedule import EPS, Instance, Schedule, remove_redundant_duplicates

__all__ = ["ish", "dsh", "list_schedule", "list_schedule_reference"]


# ---------------------------------------------------------------------- #
# mutable scheduling state
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class _State:
    dag: DAG
    n_workers: int
    free: List[float]
    by_node: Dict[str, List[Instance]]
    timeline: List[List[Instance]]  # per worker, kept sorted by start
    scheduled: set
    # incremental availability indexes, maintained by place(): best finish of
    # any instance of a node, and best finish per node per worker.  They turn
    # every arrival query — the DSH binding-chain walk's inner loop across
    # candidate workers — into O(1) lookups instead of scans over instances.
    min_fin: Dict[str, float] = dataclasses.field(default_factory=dict)
    local_fin: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    @staticmethod
    def fresh(dag: DAG, n_workers: int) -> "_State":
        return _State(
            dag=dag,
            n_workers=n_workers,
            free=[0.0] * n_workers,
            by_node={},
            timeline=[[] for _ in range(n_workers)],
            scheduled=set(),
            local_fin=[{} for _ in range(n_workers)],
        )

    # -- placement ----------------------------------------------------- #
    def place(self, node: str, worker: int, start: float, advance_free: bool = True) -> Instance:
        inst = Instance(node=node, worker=worker, start=start)
        self.by_node.setdefault(node, []).append(inst)
        insort(self.timeline[worker], inst, key=lambda i: i.start)
        fin = inst.finish(self.dag)
        prev = self.min_fin.get(node)
        if prev is None or fin < prev:
            self.min_fin[node] = fin
        lf = self.local_fin[worker]
        prev = lf.get(node)
        if prev is None or fin < prev:
            lf[node] = fin
        if advance_free:
            self.free[worker] = max(self.free[worker], fin)
        return inst

    # -- queries -------------------------------------------------------- #
    def arrival(self, u: str, consumer: str, worker: int) -> float:
        """Earliest time u's data (for edge u->consumer) is usable on worker.

        ``min(best local finish, best finish anywhere + w)`` — identical to
        the min over instances (a local instance gains nothing from +w), but
        O(1) via the incremental indexes.
        """
        best = self.min_fin[u] + self.dag.w[(u, consumer)]
        lf = self.local_fin[worker].get(u)
        if lf is not None and lf < best:
            best = lf
        return best

    def data_ready(self, node: str, worker: int) -> float:
        ps = self.dag.parents(node)
        if not ps:
            return 0.0
        return max(self.arrival(u, node, worker) for u in ps)

    def est(self, node: str, worker: int) -> float:
        """Earliest start time by appending at the worker's free cursor."""
        return max(self.free[worker], self.data_ready(node, worker))

    def to_schedule(self) -> Schedule:
        insts = tuple(
            sorted(
                (i for tl in self.timeline for i in tl),
                key=lambda i: (i.worker, i.start),
            )
        )
        return Schedule(n_workers=self.n_workers, instances=insts)


def _ready_nodes(dag: DAG, scheduled: set, in_queue: set) -> List[str]:
    out = []
    pm = dag.parent_map()
    for n in dag.nodes:
        if n in scheduled or n in in_queue:
            continue
        if all(p in scheduled for p in pm[n]):
            out.append(n)
    return out


# ---------------------------------------------------------------------- #
# ISH
# ---------------------------------------------------------------------- #
def _idle_segments(
    state: _State, worker: int, lo: float, hi: float
) -> List[Tuple[float, float]]:
    """Idle intervals of ``worker``'s timeline intersected with [lo, hi).

    The timeline is kept sorted by start and instances never overlap, so at
    most the instance immediately preceding the first start >= lo can
    straddle ``lo`` — a bisect plus a bounded scan replaces the full-timeline
    filter-and-sort.
    """
    tl = state.timeline[worker]
    dag = state.dag
    idx = bisect_left(tl, lo, key=lambda i: i.start)
    if idx > 0:
        idx -= 1  # possible straddler of lo
    segs: List[Tuple[float, float]] = []
    cur = lo
    for i in range(idx, len(tl)):
        inst = tl[i]
        if inst.start >= hi - EPS:
            break
        fin = inst.finish(dag)
        if fin <= lo + EPS:
            continue
        if inst.start > cur + EPS:
            segs.append((cur, inst.start))
        cur = max(cur, fin)
    if hi > cur + EPS:
        segs.append((cur, hi))
    return segs


def _insertion_step(
    state: _State,
    worker: int,
    gap_start: float,
    gap_end: float,
    queue: List[str],
    levels: Dict[str, float],
) -> List[str]:
    """Fill idle time in [gap_start, gap_end) on ``worker`` (paper Fig. 4).

    Idle segments are recomputed from the worker timeline each round so that
    instances already occupying part of the window (e.g. DSH duplicates) are
    respected.  Returns the list of nodes inserted (removed from ``queue``).
    """
    inserted: List[str] = []
    progress = True
    while progress:
        progress = False
        segs = _idle_segments(state, worker, gap_start, gap_end)
        if not segs:
            break
        for c in list(queue):  # queue is level-ordered; scan in order
            tc = state.dag.t[c]
            for (a, b) in segs:
                if tc > b - a + EPS:
                    continue  # can never fit even starting at a
                cs = max(a, state.data_ready(c, worker))
                if cs + tc <= b + EPS:
                    state.place(c, worker, cs, advance_free=False)
                    queue.remove(c)
                    state.scheduled.add(c)
                    inserted.append(c)
                    progress = True
                    break
            if progress:
                break
    return inserted


def ish(dag: DAG, n_workers: int) -> Schedule:
    """Insertion Scheduling Heuristic."""
    return list_schedule(dag, n_workers, duplicate=False)


def dsh(dag: DAG, n_workers: int) -> Schedule:
    """Duplication Scheduling Heuristic."""
    return list_schedule(dag, n_workers, duplicate=True)


# ---------------------------------------------------------------------- #
# DSH duplication search
# ---------------------------------------------------------------------- #
def _dsh_start(
    state: _State, node: str, worker: int,
    shared_remote: Optional[Dict[str, Tuple[Tuple[str, float], ...]]] = None,
) -> Tuple[float, List[Tuple[str, float]]]:
    """Best achievable start of ``node`` on ``worker`` with duplication.

    Kruatrachue's recursive duplication, iteratively: while ``node``'s start
    is bound by a communication, walk **up** the binding-ancestor chain until
    reaching an ancestor whose own inputs are already available on ``worker``
    (it can be recomputed locally right away), tentatively duplicate it, and
    re-evaluate.  The committed duplication list is the prefix realizing the
    best start time observed.  Returns ``(start, dups)`` where ``dups`` is a
    list of ``(node, start)`` copies to place on ``worker``.

    ``shared_remote`` is the cross-worker binding-chain cache: per chain
    node, the worker-*independent* part of each parent's arrival (best
    finish anywhere + edge latency).  No placement happens between the
    per-worker searches of one queue head, so ``min_fin`` is frozen and the
    cache built walking the chain for one worker is reused verbatim by the
    other ``m - 1`` — only the tentative/local minima are re-evaluated per
    worker, which is what stops the ~100-parent-node searches recomputing
    identical chains once per worker.
    """
    dag = state.dag
    cursor = state.free[worker]
    tent: List[Tuple[str, float]] = []  # (node, start) tentatively on worker
    tent_nodes: Dict[str, float] = {}  # node -> tentative finish
    pm = dag.parent_map()
    cm = dag.child_map()
    pw = dag.parent_weights()
    min_fin = state.min_fin
    local = state.local_fin[worker]
    local_get = local.get
    tent_get = tent_nodes.get
    min_get = min_fin.get
    INF = float("inf")
    if shared_remote is None:
        shared_remote = {}
    remote_get = shared_remote.get

    def remote(x: str) -> Tuple[Tuple[str, float], ...]:
        """Per parent of ``x``: (parent, best finish anywhere + w) — the
        worker-independent arrival component, cached across workers."""
        r = remote_get(x)
        if r is None:
            entries = []
            for u, wt in pw[x]:
                mf = min_get(u)
                entries.append((u, INF if mf is None else mf + wt))
            r = tuple(entries)
            shared_remote[x] = r
        return r

    # x -> (ready time, binding parent).  A tentative duplicate of ``d``
    # only *lowers* arrival_t(d, .), so a cached entry of a child of ``d``
    # stays valid unless ``d`` was its binding (max-arrival) parent — the
    # invalidation after each tent append pops exactly those entries.
    info_cache: Dict[str, Tuple[float, Optional[str]]] = {}

    def info(x: str) -> Tuple[float, Optional[str]]:
        """(ready time of x on ``worker``, binding parent) — memoized.

        Per-parent arrival is the O(1) min over tentative copy, committed
        local copy, and the cached remote component: this loop is the DSH
        duplication search's innermost hot path.  Searches that have not
        duplicated anything yet (the common case) skip the tentative-copy
        lookup entirely.
        """
        r = info_cache.get(x)
        if r is None:
            best = -INF
            bind: Optional[str] = None
            if tent_nodes:
                for u, ra in remote(x):
                    a = ra
                    tf = tent_get(u)
                    if tf is not None and tf < a:
                        a = tf
                    lf = local_get(u)
                    if lf is not None and lf < a:
                        a = lf
                    if a > best:  # strict: ties keep the first parent, as max
                        best, bind = a, u
            else:
                for u, ra in remote(x):
                    lf = local_get(u)
                    a = ra if lf is None or lf >= ra else lf
                    if a > best:
                        best, bind = a, u
            r = (best if bind is not None else 0.0, bind)
            info_cache[x] = r
        return r

    def on_worker(u: str) -> bool:
        return u in tent_nodes or u in local

    best_start = max(cursor, info(node)[0])
    best_prefix = 0  # number of tent entries realizing best_start

    for _ in range(len(dag.nodes)):
        if info(node)[0] <= cursor + EPS:
            break  # no communication-induced idle gap remains
        # walk up the binding-ancestor chain to a locally-recomputable node
        x = node
        dup_candidate: Optional[str] = None
        visited = set()
        while x not in visited:
            visited.add(x)
            if not pm[x]:
                break
            u = info(x)[1]  # binding parent: latest-arriving input
            if on_worker(u):
                # binding input is already local: x itself is the deepest
                # duplicable ancestor (it waits only on local finishes)
                if x is not node:
                    dup_candidate = x
                break
            if info(u)[0] <= cursor + EPS:
                dup_candidate = u  # recomputable on `worker` immediately
                break
            x = u  # u's own inputs are late; look further up the chain
        if dup_candidate is None:
            break
        ds = max(cursor, info(dup_candidate)[0])
        df = ds + dag.t[dup_candidate]
        tent.append((dup_candidate, ds))
        tent_nodes[dup_candidate] = df
        # the tent copy only lowers dup_candidate's arrival: a child's cached
        # ready time survives unless dup_candidate was its binding parent
        for c in cm[dup_candidate]:
            r = info_cache.get(c)
            if r is not None and r[1] == dup_candidate:
                del info_cache[c]
        cursor = max(cursor, df)
        new_start = max(cursor, info(node)[0])
        if new_start < best_start - EPS:
            best_start = new_start
            best_prefix = len(tent)

    return best_start, tent[:best_prefix]


# ---------------------------------------------------------------------- #
# shared per-node placement (identical for both drivers)
# ---------------------------------------------------------------------- #
def _place_head(
    state: _State,
    v: str,
    n_workers: int,
    duplicate: bool,
    insertion: bool,
    queue_factory,
    levels: Dict[str, float],
) -> List[str]:
    """Pick a worker for queue-head ``v``, place it (with DSH duplication if
    requested) and run the insertion step over any idle gap created.

    ``queue_factory()`` yields the remaining ready nodes in ``(-level,
    name)`` order; it is called only if an idle gap actually opened (so the
    fast driver never sorts its ready set on gap-free placements) and the
    returned list is mutated in place by insertion.  Returns the nodes
    inserted into the gap.
    """
    if duplicate:
        best = None
        # cross-worker binding-chain cache: no placement happens inside this
        # loop, so the remote arrival components computed walking v's
        # ancestor chains are shared verbatim across all m searches
        shared_remote: Dict[str, Tuple[Tuple[str, float], ...]] = {}
        for p in range(n_workers):
            # a duplication search on p cannot start before p's free cursor,
            # so workers already busier than the incumbent best start can be
            # skipped without changing the argmin
            if best is not None and state.free[p] > best[0][0]:
                continue
            s, dups = _dsh_start(state, v, p, shared_remote)
            key = (s, len(dups), p)
            if best is None or key < best[0]:
                best = (key, p, s, dups)
        _, p, s, dups = best
        gap_start = state.free[p]
        for (dn, dstart) in dups:
            state.place(dn, p, dstart)
        s = max(state.free[p], state.data_ready(v, p))
    else:
        p = min(range(n_workers), key=lambda p: (state.est(v, p), p))
        s = state.est(v, p)
        gap_start = state.free[p]

    state.place(v, p, s)
    state.scheduled.add(v)

    # insertion step: fill the idle gap that scheduling v created
    if insertion and s > gap_start + EPS:
        return _insertion_step(state, p, gap_start, s, queue_factory(), levels)
    return []


# ---------------------------------------------------------------------- #
# fast list-scheduling driver (heap + incremental indegrees)
# ---------------------------------------------------------------------- #
def list_schedule(
    dag: DAG,
    n_workers: int,
    duplicate: bool = False,
    insertion: bool = True,
    prune_redundant: bool = True,
) -> Schedule:
    """Heap-driven list scheduling — the fast path.

    Readiness is tracked with incremental indegrees (a node enters the ready
    heap the moment its last parent is scheduled) and the ready queue is a
    lazy-deletion heap keyed ``(-level, name)`` — the exact pop order of the
    reference driver's sort-per-refresh queue.  Newly ready nodes are
    buffered until after the insertion step, mirroring the reference's
    refresh timing, so both drivers produce identical schedules.
    """
    if n_workers < 1:
        raise ValueError("need at least one worker")
    levels = dag.levels()
    cm = dag.child_map()
    state = _State.fresh(dag, n_workers)
    remaining = dag.indegrees()

    heap: List[Tuple[float, str]] = []
    in_queue: Set[str] = set()

    def push(n: str) -> None:
        heapq.heappush(heap, (-levels[n], n))
        in_queue.add(n)

    def newly_ready(n: str, out: List[str]) -> None:
        for c in cm[n]:
            remaining[c] -= 1
            if remaining[c] == 0:
                out.append(c)

    for n in dag.nodes:
        if remaining[n] == 0:
            push(n)

    while in_queue:
        # lazy deletion: skip heap entries removed by the insertion step
        while True:
            _, v = heapq.heappop(heap)
            if v in in_queue:
                break
        in_queue.discard(v)

        pending: List[str] = []
        inserted = _place_head(
            state, v, n_workers, duplicate, insertion,
            lambda: sorted(in_queue, key=lambda n: (-levels[n], n)),
            levels,
        )
        newly_ready(v, pending)
        for c in inserted:
            in_queue.discard(c)
            newly_ready(c, pending)
        # refresh: push nodes made ready by v and by inserted nodes
        for c in pending:
            push(c)

    sched = state.to_schedule()
    if duplicate and prune_redundant:
        sched = remove_redundant_duplicates(sched, dag)
    return sched


# ---------------------------------------------------------------------- #
# reference driver (original full-rescan semantics oracle)
# ---------------------------------------------------------------------- #
def list_schedule_reference(
    dag: DAG,
    n_workers: int,
    duplicate: bool = False,
    insertion: bool = True,
    prune_redundant: bool = True,
) -> Schedule:
    """The original O(V·(V+E)) driver: full ready-rescan + sort per
    placement.  Kept as the oracle for fast-path equivalence tests."""
    if n_workers < 1:
        raise ValueError("need at least one worker")
    levels = dag.levels()
    state = _State.fresh(dag, n_workers)
    queue: List[str] = []
    in_queue: set = set()

    def refresh_queue() -> None:
        for n in _ready_nodes(dag, state.scheduled, in_queue):
            queue.append(n)
            in_queue.add(n)
        queue.sort(key=lambda n: (-levels[n], n))

    refresh_queue()
    while queue:
        v = queue.pop(0)
        in_queue.discard(v)
        _place_head(state, v, n_workers, duplicate, insertion, lambda: queue, levels)
        # rebuild in_queue after insertion-step removals
        in_queue.intersection_update(queue)
        refresh_queue()

    sched = state.to_schedule()
    if duplicate and prune_redundant:
        sched = remove_redundant_duplicates(sched, dag)
    return sched
