"""Anytime branch-and-bound search for (near-)optimal schedules (paper §3.1-3.4).

The paper encodes the DAG-scheduling-with-duplication problem in OPL and
solves it with CP Optimizer, comparing Tang et al.'s encoding (4-D
communication decision variable ``d_{a_i,b_j}``) against an improved encoding
that removes ``d`` in favour of *earliest-finish* semantics (constraints
9-13).  No certifiable MILP solver exists in our toolchain (nor would one be
in an aeronautical one), so both encodings are realized as **propagation
modes of the same chronological branch-and-bound engine**, which keeps the
comparison apples-to-apples:

* ``encoding="improved"`` — cross-worker arrival of an input is
  ``min over placed instances (finish + w)`` (constraint 11) and the number
  of copies of a node is bounded by its child count (constraint 9).
* ``encoding="tang"`` — the supplier of every consumed edge is a *decision*:
  the engine branches over supplier combinations (the ``d`` variable made
  explicit), and duplication is only bounded by one-instance-per-worker
  (constraints 1/6).  Dominated supplier choices are explored and pruned
  late, reproducing the scaling gap of paper Fig. 8 / Observation 1.

Shared machinery: critical-path + load lower bounds, incumbent seeding from
DSH (the hybrid suggested in paper §4.3), worker-symmetry breaking,
Chou-Chung-style equivalence/dominance pruning over canonicalized schedule
states (§3.4), and a wall-clock timeout with anytime best-so-far results.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.core.graph import DAG
from repro_torch.core.list_scheduling import dsh, ish
from repro_torch.core.schedule import EPS, Instance, Schedule, remove_redundant_duplicates, validate

__all__ = ["SolverResult", "branch_and_bound", "tighten_schedule"]


@dataclasses.dataclass
class SolverResult:
    schedule: Schedule
    makespan: float
    optimal: bool
    nodes_explored: int
    elapsed_s: float
    encoding: str
    from_seed: bool = False  # incumbent is the (unconstrained) DSH seed


class _SearchState:
    __slots__ = ("free", "placements", "count", "n_placed_nodes")

    def __init__(self, n_workers: int, n_nodes: int):
        self.free = [0.0] * n_workers
        # node -> list[(worker, finish)]
        self.placements: Dict[str, List[Tuple[int, float]]] = {}
        self.count: Dict[str, int] = {}
        self.n_placed_nodes = 0


def branch_and_bound(
    dag: DAG,
    n_workers: int,
    encoding: str = "improved",
    timeout_s: float = 10.0,
    allow_duplication: bool = True,
    seed_with_dsh: bool = True,
    incumbent: Optional[Schedule] = None,
    max_supplier_branches: int = 16,
    state_table_cap: int = 200_000,
) -> SolverResult:
    """Anytime branch and bound; ``timeout_s`` is the wall-clock budget.

    ``incumbent`` warm-starts the search from an externally computed schedule
    (e.g. a fast-path ISH/DSH schedule on a large graph): its makespan
    becomes the initial upper bound, so the solver spends the whole budget
    *tightening* a known-good schedule instead of first re-deriving one.
    When both ``incumbent`` and ``seed_with_dsh`` are given, the better of
    the two seeds wins.  Like the DSH seed (paper §4.3), the incumbent is
    not subject to the encoding's duplication bound — ``from_seed`` tracks
    whether the returned schedule is still the seed.
    """
    if encoding not in ("improved", "tang"):
        raise ValueError(f"unknown encoding {encoding!r}")
    t0 = time.monotonic()
    nodes = dag.nodes
    parents = dag.parent_map()
    children = dag.child_map()
    levels = dag.levels()
    tmap = dag.t
    wmap = dag.w

    # duplication upper bound per node (improved: constraint 9; tang: 1/worker)
    if encoding == "improved":
        dup_bound = {
            n: (1 if not children[n] else min(n_workers, len(children[n])))
            for n in nodes
        }  # sink never duplicated (constraint 6)
    else:
        dup_bound = {n: (1 if not children[n] else n_workers) for n in nodes}
    if not allow_duplication:
        dup_bound = {n: 1 for n in nodes}

    # Chou-Chung equivalence classes: interchangeable ready nodes explored once.
    eq_class: Dict[str, str] = {}
    sig_map: Dict[Tuple, str] = {}
    for n in sorted(nodes):
        sig = (
            frozenset(parents[n]),
            frozenset(children[n]),
            tmap[n],
            tuple(sorted(wmap[(p, n)] for p in parents[n])),
            tuple(sorted(wmap[(n, c)] for c in children[n])),
        )
        eq_class[n] = sig_map.setdefault(sig, n)

    # incumbent (the DSH hybrid warm start of paper §4.3; note the seed is
    # not subject to the encoding's duplication bound — only search results
    # are, tracked via `from_seed`)
    best_mk = float("inf")
    best_sched: Optional[Schedule] = None
    best_from_seed = False
    if incumbent is not None:
        validate(incumbent, dag)
        if incumbent.n_workers > n_workers:
            raise ValueError("incumbent uses more workers than the search")
        best_sched = incumbent
        best_mk = incumbent.makespan(dag)
        best_from_seed = True
    if seed_with_dsh:
        s = dsh(dag, n_workers)
        mk = s.makespan(dag)
        if mk < best_mk:
            best_sched = s
            best_mk = mk
            best_from_seed = True

    st = _SearchState(n_workers, len(nodes))
    explored = 0
    timed_out = False
    state_table: Dict[Tuple, List[Tuple[float, ...]]] = {}

    def arrival_options(u: str, v: str, worker: int) -> List[float]:
        we = wmap[(u, v)]
        return [f + (0.0 if wk == worker else we) for (wk, f) in st.placements[u]]

    def est_on(v: str, worker: int) -> float:
        s = st.free[worker]
        for u in parents[v]:
            s = max(s, min(arrival_options(u, v, worker)))
        return s

    def lower_bound() -> float:
        # current makespan
        lb = max(st.free)
        # load bound: all work must fit on m workers
        placed_work = sum(
            tmap[n] * len(pl) for n, pl in st.placements.items()
        )
        unplaced_work = sum(tmap[n] for n in nodes if n not in st.placements)
        lb = max(lb, (placed_work + unplaced_work) / n_workers)
        # critical-path bound ignoring communication (admissible: duplication
        # can always elide comm)
        lb_est: Dict[str, float] = {}
        for n in dag.topological_order():
            if n in st.placements:
                lb_est[n] = min(f for (_wk, f) in st.placements[n]) - tmap[n]
                continue
            e = 0.0
            for u in parents[n]:
                e = max(e, lb_est[u] + tmap[u])
            lb_est[n] = e
        for n in nodes:
            if n not in st.placements:
                lb = max(lb, lb_est[n] + levels[n])
        return lb

    def canonical_key() -> Tuple:
        per_worker: List[Tuple] = []
        node_sets: List[Tuple] = []
        byw: Dict[int, List[Tuple[str, float]]] = {p: [] for p in range(n_workers)}
        for n, pls in st.placements.items():
            for (wk, f) in pls:
                byw[wk].append((n, f))
        order = sorted(range(n_workers), key=lambda p: tuple(sorted(x[0] for x in byw[p])))
        vec: List[float] = []
        for p in order:
            names = tuple(sorted(x[0] for x in byw[p]))
            node_sets.append(names)
            vec.append(st.free[p])
            vec.extend(f for (_n, f) in sorted(byw[p]))
        key = (tuple(sorted((n, len(p)) for n, p in st.placements.items())), tuple(node_sets))
        return key, tuple(vec)

    def dominated_or_record(key: Tuple, vec: Tuple[float, ...]) -> bool:
        entries = state_table.get(key)
        if entries is None:
            if len(state_table) < state_table_cap:
                state_table[key] = [vec]
            return False
        for e in entries:
            if len(e) == len(vec) and all(a <= b + EPS for a, b in zip(e, vec)):
                return True  # dominated (or equivalent) by a visited state
        entries[:] = [e for e in entries if not all(b <= a + EPS for a, b in zip(e, vec))]
        entries.append(vec)
        return False

    def ready_and_dups() -> Tuple[List[str], List[str]]:
        ready = []
        dups = []
        for n in nodes:
            cnt = len(st.placements.get(n, ()))
            if cnt == 0:
                if all(u in st.placements for u in parents[n]):
                    ready.append(n)
            elif (
                cnt < dup_bound[n]
                and any(c not in st.placements for c in children[n])
            ):
                dups.append(n)
        return ready, dups

    def place(v: str, worker: int, start: float) -> None:
        f = start + tmap[v]
        st.placements.setdefault(v, []).append((worker, f))
        st.free[worker] = max(st.free[worker], f)

    def unplace(v: str, worker: int, prev_free: float) -> None:
        pls = st.placements[v]
        for i in range(len(pls) - 1, -1, -1):
            if pls[i][0] == worker:
                pls.pop(i)
                break
        if not pls:
            del st.placements[v]
        st.free[worker] = prev_free

    def start_candidates(v: str, worker: int) -> List[float]:
        """Start times to branch on for (v, worker)."""
        if encoding == "improved" or not parents[v]:
            return [est_on(v, worker)]
        # tang: supplier of each edge is a decision variable — enumerate
        per_parent = []
        for u in parents[v]:
            opts = sorted(set(arrival_options(u, v, worker)))
            per_parent.append(opts)
        combos = itertools.islice(itertools.product(*per_parent), max_supplier_branches)
        starts = sorted({max(st.free[worker], max(c)) for c in combos})
        return starts

    def snapshot_schedule() -> Schedule:
        insts = []
        for n, pls in st.placements.items():
            for (wk, f) in pls:
                insts.append(Instance(node=n, worker=wk, start=f - tmap[n]))
        return Schedule(
            n_workers=n_workers, instances=tuple(sorted(insts, key=lambda i: (i.worker, i.start)))
        )

    def dfs() -> None:
        nonlocal explored, best_mk, best_sched, timed_out, best_from_seed
        if timed_out or time.monotonic() - t0 > timeout_s:
            timed_out = True
            return
        explored += 1
        if st.n_placed_nodes == len(nodes):
            mk = max(st.free)
            if mk < best_mk - EPS:
                best_mk = mk
                best_sched = snapshot_schedule()
                best_from_seed = False
            return
        if lower_bound() >= best_mk - EPS:
            return
        key, vec = canonical_key()
        if dominated_or_record(key, vec):
            return

        ready, dups = ready_and_dups()
        # equivalence pruning: one representative per Chou-Chung class
        reps: Dict[str, str] = {}
        for v in ready:
            c = eq_class[v]
            if c not in reps or v < reps[c]:
                reps[c] = v
        ready = sorted(reps.values(), key=lambda n: (-levels[n], n))

        moves: List[Tuple[float, str, int, float, bool]] = []
        used_workers = {wk for pls in st.placements.values() for (wk, _f) in pls}
        worker_cap = min(n_workers, len(used_workers) + 1)  # symmetry breaking
        for v in ready:
            for p in range(worker_cap):
                for s in start_candidates(v, p):
                    moves.append((s + levels[v], v, p, s, False))
        if allow_duplication:
            for v in dups:
                placed_on = {wk for (wk, _f) in st.placements[v]}
                for p in range(worker_cap):
                    if p in placed_on:
                        continue
                    s = est_on(v, p)
                    moves.append((s + levels[v], v, p, s, True))
        moves.sort(key=lambda m: (m[0], m[1], m[2]))

        for (_prio, v, p, s, is_dup) in moves:
            if s + tmap[v] + (0.0 if is_dup else 0.0) >= best_mk - EPS and is_dup:
                continue
            prev_free = st.free[p]
            place(v, p, s)
            if not is_dup:
                st.n_placed_nodes += 1
            dfs()
            if not is_dup:
                st.n_placed_nodes -= 1
            unplace(v, p, prev_free)
            if timed_out:
                return

    dfs()

    if best_sched is not None:
        best_sched = remove_redundant_duplicates(best_sched, dag)
        validate(best_sched, dag)
    return SolverResult(
        schedule=best_sched,
        makespan=best_mk,
        optimal=not timed_out,
        nodes_explored=explored,
        elapsed_s=time.monotonic() - t0,
        encoding=encoding,
        from_seed=best_from_seed,
    )


def tighten_schedule(
    dag: DAG,
    n_workers: int,
    schedule: Optional[Schedule] = None,
    timeout_s: float = 5.0,
    heuristic: str = "dsh",
    seed_with_dsh: bool = False,
    **kwargs,
) -> SolverResult:
    """Hybrid fast-path + exact-search driver (ROADMAP: exact-solver warm
    starts).

    Computes a fast-path heuristic schedule (``heuristic``: ``"ish"`` or
    ``"dsh"``) when none is supplied, then hands it to
    :func:`branch_and_bound` as the incumbent with a ``timeout_s`` wall-clock
    budget.  The result is never worse than the heuristic schedule; on small
    graphs the search typically closes the instance, on large graphs it
    anytime-tightens within the budget.
    """
    if "incumbent" in kwargs:
        raise ValueError("pass the incumbent via the `schedule` argument")
    if schedule is None:
        if heuristic not in ("ish", "dsh"):
            raise ValueError(f"unknown heuristic {heuristic!r}")
        schedule = (dsh if heuristic == "dsh" else ish)(dag, n_workers)
    return branch_and_bound(
        dag,
        n_workers,
        timeout_s=timeout_s,
        incumbent=schedule,
        seed_with_dsh=seed_with_dsh,
        **kwargs,
    )
