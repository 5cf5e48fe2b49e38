"""Task-DAG model of a neural network (paper §2.2).

A directed acyclic graph ``(V, E, t, w)`` where nodes are layers (or finer
operator slices), ``t(v)`` is the per-worker cost of node ``v`` and ``w(e)``
the communication latency paid when the endpoints of ``e`` land on distinct
workers.  On the paper's CPU target these are OTAWA WCETs; on our TPU target
they come from the roofline cost model (:mod:`repro.core.costmodel`).
"""
from __future__ import annotations

import dataclasses
import heapq
import random as _random
from typing import Callable, Dict, FrozenSet, Iterable, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "DAG",
    "GraphError",
    "random_dag",
    "density",
]


class GraphError(ValueError):
    """Raised for malformed graphs (cycles, unknown nodes, ...)."""


@dataclasses.dataclass(frozen=True)
class DAG:
    """Immutable task DAG.

    Attributes
    ----------
    nodes:   tuple of hashable node ids (layer names).
    edges:   tuple of ``(u, v)`` pairs, data flowing u -> v.
    t:       mapping node -> execution cost on one worker (WCET analogue).
    w:       mapping edge -> communication latency if endpoints differ.
    meta:    optional per-node metadata.  Operator-granularity DAGs use it to
             record each slice task's originating layer and tile coordinates
             (keys ``origin``/``tile``/``op``; grid tiles carry
             ``("grid", (row_lo, row_hi), (c_lo, c_hi))``) plus the
             per-parent input windows (``in_boxes``, one per-axis interval
             tuple per parent edge) that ``build_plan`` turns into windowed
             transfer hulls; schedulers ignore it, but plan summaries and
             benchmarks group nodes by origin through it.

    Adjacency queries (``parents``/``children``/``topological_order``/
    ``levels``/...) are memoized on first use: the DAG is immutable, so the
    derived structures are computed exactly once and every subsequent call is
    a dict lookup.  Schedulers walking thousands of nodes rely on this.
    """

    nodes: Tuple[str, ...]
    edges: Tuple[Tuple[str, str], ...]
    t: Mapping[str, float]
    w: Mapping[Tuple[str, str], float]
    meta: Mapping[str, Mapping[str, object]] = dataclasses.field(default_factory=dict)

    def _memo(self, key: str, fn: Callable[[], object]):
        cache = self.__dict__.get("_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_cache", cache)
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    # ------------------------------------------------------------------ #
    # construction & validation
    # ------------------------------------------------------------------ #
    def __post_init__(self) -> None:
        node_set = set(self.nodes)
        if len(node_set) != len(self.nodes):
            raise GraphError("duplicate node ids")
        for (u, v) in self.edges:
            if u not in node_set or v not in node_set:
                raise GraphError(f"edge ({u},{v}) references unknown node")
            if u == v:
                raise GraphError(f"self loop on {u}")
        if len(set(self.edges)) != len(self.edges):
            raise GraphError("duplicate edges")
        for n in self.nodes:
            if n not in self.t:
                raise GraphError(f"missing cost t({n})")
            if self.t[n] < 0:
                raise GraphError(f"negative cost t({n})")
        for e in self.edges:
            if e not in self.w:
                raise GraphError(f"missing weight w({e})")
            if self.w[e] < 0:
                raise GraphError(f"negative weight w({e})")
        for n in self.meta:
            if n not in node_set:
                raise GraphError(f"meta references unknown node {n}")
        # cycle check via topological order (raises on cycle)
        self.topological_order()

    @staticmethod
    def build(
        nodes: Iterable[str],
        edges: Iterable[Tuple[str, str]],
        t: Mapping[str, float],
        w: Optional[Mapping[Tuple[str, str], float]] = None,
        default_w: float = 0.0,
        meta: Optional[Mapping[str, Mapping[str, object]]] = None,
    ) -> "DAG":
        nodes = tuple(nodes)
        edges = tuple(tuple(e) for e in edges)
        w = dict(w or {})
        for e in edges:
            w.setdefault(e, default_w)
        return DAG(nodes=nodes, edges=edges, t=dict(t), w=w, meta=dict(meta or {}))

    # ------------------------------------------------------------------ #
    # basic structure
    # ------------------------------------------------------------------ #
    def parents(self, v: str) -> Tuple[str, ...]:
        return self.parent_map()[v]

    def children(self, v: str) -> Tuple[str, ...]:
        return self.child_map()[v]

    def parent_map(self) -> Dict[str, Tuple[str, ...]]:
        def build() -> Dict[str, Tuple[str, ...]]:
            m: Dict[str, List[str]] = {n: [] for n in self.nodes}
            for (u, v) in self.edges:
                m[v].append(u)
            return {k: tuple(vs) for k, vs in m.items()}

        return self._memo("parent_map", build)

    def child_map(self) -> Dict[str, Tuple[str, ...]]:
        def build() -> Dict[str, Tuple[str, ...]]:
            m: Dict[str, List[str]] = {n: [] for n in self.nodes}
            for (u, v) in self.edges:
                m[u].append(v)
            return {k: tuple(vs) for k, vs in m.items()}

        return self._memo("child_map", build)

    def parent_weights(self) -> Dict[str, Tuple[Tuple[str, float], ...]]:
        """node -> ((parent, w(parent, node)), ...) in parent order (cached).

        Schedulers' inner loops pay per-edge tuple hashing when they look up
        ``w[(u, v)]`` parent-by-parent; this flattens the weights next to the
        parents once so hot paths iterate a prebuilt tuple instead.
        """

        def build() -> Dict[str, Tuple[Tuple[str, float], ...]]:
            pm = self.parent_map()
            return {
                v: tuple((u, self.w[(u, v)]) for u in ps)
                for v, ps in pm.items()
            }

        return self._memo("parent_weights", build)

    def indegrees(self) -> Dict[str, int]:
        """Number of parents per node (copy-safe: callers may mutate)."""
        pm = self.parent_map()
        return {n: len(pm[n]) for n in self.nodes}

    def sources(self) -> Tuple[str, ...]:
        pm = self.parent_map()
        return self._memo(
            "sources", lambda: tuple(n for n in self.nodes if not pm[n])
        )

    def sinks(self) -> Tuple[str, ...]:
        cm = self.child_map()
        return self._memo(
            "sinks", lambda: tuple(n for n in self.nodes if not cm[n])
        )

    def topological_order(self) -> Tuple[str, ...]:
        """Kahn's algorithm; deterministic (input node order breaks ties).

        Heap-ordered ready set keyed by input position — O((V+E) log V)
        with the exact tie-breaking of the original sort-based variant.
        """
        return self._memo("topo", self._topological_order)

    def _topological_order(self) -> Tuple[str, ...]:
        indeg = {n: 0 for n in self.nodes}
        cm: Dict[str, List[str]] = {n: [] for n in self.nodes}
        for (u, v) in self.edges:
            indeg[v] += 1
            cm[u].append(v)
        pos = {n: i for i, n in enumerate(self.nodes)}
        ready = [pos[n] for n in self.nodes if indeg[n] == 0]
        heapq.heapify(ready)
        order: List[str] = []
        while ready:
            n = self.nodes[heapq.heappop(ready)]
            order.append(n)
            for c in cm[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    heapq.heappush(ready, pos[c])
        if len(order) != len(self.nodes):
            raise GraphError("graph has a cycle")
        return tuple(order)

    # ------------------------------------------------------------------ #
    # paper-specific helpers
    # ------------------------------------------------------------------ #
    def one_sink(self, sink_name: str = "__sink__", sink_cost: float = 0.0) -> "DAG":
        """Return an equivalent single-sink DAG (paper §2.2, Fig. 3 red part).

        A zero-cost virtual node is appended, fed by every former sink with
        zero-latency edges.  If the graph already has a unique sink it is
        returned unchanged.
        """
        sinks = self.sinks()
        if len(sinks) == 1:
            return self
        if sink_name in self.nodes:
            raise GraphError(f"sink name {sink_name!r} already used")
        nodes = self.nodes + (sink_name,)
        new_edges = self.edges + tuple((s, sink_name) for s in sinks)
        t = dict(self.t)
        t[sink_name] = sink_cost
        w = dict(self.w)
        for s in sinks:
            w[(s, sink_name)] = 0.0
        return DAG(nodes=nodes, edges=new_edges, t=t, w=w, meta=dict(self.meta))

    def levels(self) -> Dict[str, float]:
        """Critical-path level of each node (paper §3.3, Kruatrachue).

        ``level(v) = t(v) + max over children c of (level(c))`` — the sum of
        node execution times along the longest path from ``v`` to the sink
        (communication weights excluded, as in the classical definition).
        """

        def build() -> Dict[str, float]:
            lv: Dict[str, float] = {}
            cm = self.child_map()
            for n in reversed(self.topological_order()):
                cs = cm[n]
                lv[n] = self.t[n] + (max(lv[c] for c in cs) if cs else 0.0)
            return lv

        return self._memo("levels", build)

    def levels_with_comm(self) -> Dict[str, float]:
        """Levels including edge weights on the path (a tighter priority)."""

        def build() -> Dict[str, float]:
            lv: Dict[str, float] = {}
            cm = self.child_map()
            for n in reversed(self.topological_order()):
                cs = cm[n]
                lv[n] = self.t[n] + (
                    max(lv[c] + self.w[(n, c)] for c in cs) if cs else 0.0
                )
            return lv

        return self._memo("levels_with_comm", build)

    def sequential_makespan(self) -> float:
        """Makespan of the whole DAG on a single worker (no communication)."""
        return float(sum(self.t[n] for n in self.nodes))

    def critical_path_length(self, with_comm: bool = False) -> float:
        lv = self.levels_with_comm() if with_comm else self.levels()
        return max(lv.values()) if lv else 0.0

    def max_parallelism(self) -> int:
        """Maximum antichain width — the speedup plateau of paper Obs. 1.

        Computed as the maximum, over a topological sweep, of concurrently
        "open" nodes (nodes whose parents are all done but that are not
        ancestors/descendants of each other).  Exact max-antichain is
        NP-ish on general DAGs via Dilworth; we use the standard layered
        approximation: max width over ASAP layers, which matches the paper's
        usage (number of parallel branches).
        """
        pm = self.parent_map()
        depth: Dict[str, int] = {}
        for n in self.topological_order():
            ps = pm[n]
            depth[n] = 1 + max((depth[p] for p in ps), default=-1)
        width: Dict[int, int] = {}
        for n, d in depth.items():
            width[d] = width.get(d, 0) + 1
        return max(width.values()) if width else 0

    def subgraph(self, keep: Iterable[str]) -> "DAG":
        keep_set = set(keep)
        nodes = tuple(n for n in self.nodes if n in keep_set)
        edges = tuple(e for e in self.edges if e[0] in keep_set and e[1] in keep_set)
        return DAG(
            nodes=nodes,
            edges=edges,
            t={n: self.t[n] for n in nodes},
            w={e: self.w[e] for e in edges},
            meta={n: m for n, m in self.meta.items() if n in keep_set},
        )

    def relabel(self, fn: Callable[[str], str]) -> "DAG":
        return DAG(
            nodes=tuple(fn(n) for n in self.nodes),
            edges=tuple((fn(u), fn(v)) for (u, v) in self.edges),
            t={fn(n): c for n, c in self.t.items()},
            w={(fn(u), fn(v)): c for (u, v), c in self.w.items()},
            meta={fn(n): m for n, m in self.meta.items()},
        )

    # ------------------------------------------------------------------ #
    # slice metadata
    # ------------------------------------------------------------------ #
    def origin(self, v: str) -> str:
        """Originating layer of node ``v`` (``v`` itself when unsliced)."""
        m = self.meta.get(v)
        return str(m["origin"]) if m and "origin" in m else v

    def by_origin(self) -> Dict[str, Tuple[str, ...]]:
        """origin layer -> the slice/glue nodes lowered from it (cached)."""

        def build() -> Dict[str, Tuple[str, ...]]:
            m: Dict[str, List[str]] = {}
            for n in self.nodes:
                m.setdefault(self.origin(n), []).append(n)
            return {k: tuple(v) for k, v in m.items()}

        return self._memo("by_origin", build)


def density(dag: DAG) -> float:
    """Edge density per paper eq. (14): |E| / (|V|(|V|-1)/2)."""
    n = len(dag.nodes)
    if n < 2:
        return 0.0
    return len(dag.edges) / (n * (n - 1) / 2.0)


def random_dag(
    n_nodes: int,
    dens: float = 0.10,
    seed: int = 0,
    t_range: Tuple[float, float] = (1.0, 10.0),
    w_range: Tuple[float, float] = (1.0, 10.0),
    integer_costs: bool = True,
    one_sink: bool = True,
) -> DAG:
    """Random DAG generator following the paper's three-step process (§4.1).

    (1) nodes with unique indices; (2) edges from lower to higher indices to
    guarantee acyclicity, sampled to hit the requested density; (3) single-sink
    enforcement.  Costs/weights uniform in ``[1, 10]`` by default.
    """
    rng = _random.Random(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    max_edges = n_nodes * (n_nodes - 1) // 2
    target = min(max_edges, max(n_nodes - 1, round(dens * max_edges)))
    all_pairs = [(names[i], names[j]) for i in range(n_nodes) for j in range(i + 1, n_nodes)]
    # Ensure weak connectivity-ish: every non-first node gets >= 1 parent.
    edges = set()
    for j in range(1, n_nodes):
        i = rng.randrange(j)
        edges.add((names[i], names[j]))
    remaining = [p for p in all_pairs if p not in edges]
    rng.shuffle(remaining)
    for p in remaining[: max(0, target - len(edges))]:
        edges.add(p)

    def draw(lo: float, hi: float) -> float:
        if integer_costs:
            return float(rng.randint(int(lo), int(hi)))
        return rng.uniform(lo, hi)

    # draw in sorted edge order: iterating the set directly made the weight
    # assignment depend on PYTHONHASHSEED (different DAGs across processes)
    edges = tuple(sorted(edges))
    t = {n: draw(*t_range) for n in names}
    w = {e: draw(*w_range) for e in edges}
    dag = DAG(nodes=tuple(names), edges=edges, t=t, w=w)
    if one_sink:
        dag = dag.one_sink()
    return dag
