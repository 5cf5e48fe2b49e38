"""Schedule -> ExecutionPlan: the paper's code-generation step, made static.

ACETONE emits one C inference function per core, with *Writing*/*Reading*
operators around every cross-core edge (paper §5.2-5.3).  On TPU the flag
protocol's guarantees hold by construction in SSA dataflow, so the plan is a
sequence of **supersteps**: a per-worker compute segment followed by a
global communication round (the Writing/Reading pairs of that round).  The
executor turns each comm round into ``lax.ppermute`` collectives; the paper's
per-(src,dst) flag+array channel becomes one permute edge.

The plan is built from the *schedule*, not re-derived: the supplier of each
cross-worker edge is the schedule's availability argmin, matching the
improved encoding's earliest-finish semantics (constraint 11).

**Segmented canonicalization** (the second half of this module) re-expresses
a plan in the uniform shape the segmented ``lax.scan`` executor needs:

* :func:`pack_registers` maps the dict-of-registers onto one packed per-worker
  buffer — every register gets a static element offset, and (given a liveness
  pass) dead registers' slots are reused by later births, so the scan carry is
  a single fixed-size array instead of a per-superstep pytree;
* :func:`build_segments` chops the plan into **segments** of supersteps,
  expands each superstep into uniform *ticks* (one node per worker per tick),
  and lowers every comm round onto a fixed per-segment schema: ring-shift
  ``ppermute`` rounds (one round per source→destination distance ``δ``, a
  full static permutation each), payloads padded to one fixed length per
  round, and per-(tick, worker) gather/scatter **index rows** into the packed
  buffer.  Padding entries carry ``pad_index`` — the executor points it at a
  dump column *past every register* (padding lanes gather that column's
  don't-care bytes and scatter back into it), so padding can never touch a
  real register or change a shipped window, which
  :mod:`tests.test_scan_executor` asserts as a property.  Each segment also
  carries a :class:`SegmentStaging` placing every tick's landed payload
  block — write-once strips (``buffer_depth=1``) or ``buffer_depth``
  rotating frames whose occupants the executor retires back to their
  packed columns before reuse (the streaming double/quad-buffer layout).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.costmodel import box_bytes as _box_bytes
from repro_torch.core.graph import DAG
from repro_torch.core.schedule import Instance, Schedule

__all__ = [
    "Transfer",
    "Superstep",
    "ExecutionPlan",
    "build_plan",
    "coalesce_transfer_steps",
    "plan_summary",
    "plan_fingerprint",
    "pack_registers",
    "build_segments",
    "CommRound",
    "PlanSegment",
    "SegmentStaging",
    "RegisterLayout",
    "migrate_registers",
    "WCETCertificate",
    "wcet_certificate",
]

Box = Tuple[Tuple[int, int], ...]  # per-sample-axis (lo, hi) payload window


@dataclasses.dataclass(frozen=True)
class Transfer:
    node: str      # value being communicated (producer layer name)
    src: int
    dst: int
    # window of the producer register actually consumed on ``dst`` — the
    # hull of every consumer-edge intersection there (``None`` = whole
    # register).  The executor ships only this window (ACETONE's Writing/
    # Reading channels carry exactly the bytes the reader needs, paper §5).
    box: Optional[Box] = None

    def label(self) -> str:
        return f"{self.src}_{self.dst}_{self.node}"  # paper's src_dst_id norm

    def box_bytes(self, dtype_bytes: int = 4) -> Optional[float]:
        if self.box is None:
            return None
        return _box_bytes(self.box, dtype_bytes)


@dataclasses.dataclass(frozen=True)
class Superstep:
    compute: Tuple[Tuple[str, ...], ...]   # per-worker ordered node lists
    transfers: Tuple[Transfer, ...]        # global comm round after compute


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    n_workers: int
    steps: Tuple[Superstep, ...]
    makespan: float                        # scheduler's predicted makespan
    sink: str
    sink_worker: int

    @property
    def n_transfers(self) -> int:
        return sum(len(s.transfers) for s in self.steps)

    def comm_bytes(self, out_bytes: Dict[str, float]) -> float:
        """Total scheduled transfer payload: windowed transfers count their
        box bytes, whole-register transfers the producer's output bytes."""
        total = 0.0
        for s in self.steps:
            for t in s.transfers:
                b = t.box_bytes()
                total += out_bytes[t.node] if b is None else b
        return total


def plan_fingerprint(plan: ExecutionPlan) -> str:
    """Content hash of a plan's full observable structure (supersteps,
    per-worker compute order, transfers with boxes) — the memo key for
    validation caching: equal fingerprints validate identically."""
    h = hashlib.sha256()
    h.update(f"{plan.n_workers}|{plan.sink}|{plan.sink_worker}".encode())
    for step in plan.steps:
        for nodes in step.compute:
            h.update("|".join(nodes).encode())
            h.update(b";")
        for t in step.transfers:
            h.update(f"{t.node}>{t.src}>{t.dst}>{t.box}".encode())
        h.update(b"#")
    return h.hexdigest()


def build_plan(schedule: Schedule, dag: DAG, lookahead: bool = True) -> ExecutionPlan:
    """Chop a valid schedule into compute/comm supersteps.

    Greedy simulation: repeatedly (1) let every worker run the maximal prefix
    of its sub-schedule whose inputs are locally available, (2) emit one comm
    round containing, for every worker's next blocked instance, the transfers
    of its missing inputs from their schedule-designated suppliers.  A valid
    schedule can always make progress, so this terminates.

    ``lookahead=True`` additionally ships every *future* cross-worker input
    of each sub-schedule in the first comm round after its producer exists
    (a "want list" computed once up front — each want ships exactly once, so
    the eager mode costs O(E) total, not a per-round rescan).  Inputs the
    worker computes itself before the consuming instance are never wants.
    Operator-granularity plans are dominated by slice tasks whose inputs
    finish long before the consumer's turn; pre-shipping them collapses long
    chains of one-transfer supersteps into a few wide rounds, which is what
    keeps sliced MPMD traces shallow.  ``lookahead=False`` reproduces the
    certification-literal head-only rounds.

    Per-worker sub-schedules are consumed through index cursors (no
    ``pop(0)``), adjacency comes from the DAG's cached parent map, and each
    node's supplier candidates are pre-sorted once by ``(finish, worker)``
    so picking the earliest-finishing *available* instance is a prefix scan
    — O(V·m + E) per plan instead of O(V²·m).
    """
    sinks = dag.sinks()
    if len(sinks) != 1:
        raise ValueError(
            f"build_plan supports single-sink DAGs only; this DAG has "
            f"{len(sinks)} sinks {list(sinks)}.  A multi-sink plan would "
            "silently drop every output but the first and retire the extra "
            "sinks' registers early in the liveness pass — merge the outputs "
            "first (e.g. DAG.one_sink()) or build one plan per output."
        )
    m = schedule.n_workers
    subs: List[Tuple[Instance, ...]] = [schedule.sub_schedule(w) for w in range(m)]
    heads = [0] * m                        # cursor into each sub-schedule
    have: Set[Tuple[str, int]] = set()     # (node, worker) locally available
    computed: Set[Tuple[str, int]] = set() # (node, worker) computed there
    pm = dag.parent_map()
    cm = dag.child_map()
    by_node = schedule.by_node()
    # supplier candidates per node, earliest-finish first (constraint 11)
    candidates: Dict[str, List[Instance]] = {
        n: sorted(insts, key=lambda iu: (iu.finish(dag), iu.worker))
        for n, insts in by_node.items()
    }

    def supplier(u: str) -> Optional[Instance]:
        # only instances whose worker *computed* the value can supply (a
        # worker that merely received it may hold just a window, and two
        # hops of the same value in one fused comm round would read the
        # relay's pre-round register); pick the earliest-finishing one
        # (constraint-11 semantics).
        for iu in candidates[u]:
            if (u, iu.worker) in computed:
                return iu
        return None  # value not produced anywhere yet — wait a round

    def edge_box(u: str, w: int):
        """Hull of the windows every consumer of ``u`` scheduled on ``w``
        reads (``None`` = some consumer needs the whole register).  Boxes
        come from DAG node metadata (``in_boxes``, parent-edge aligned),
        emitted by the operator-granularity slicer; they are per-axis
        interval tuples, so hulls of 2-D grid-tile windows (rows ×
        channels) compose the same way as single-axis windows."""
        hull: Optional[List[Tuple[int, int]]] = None
        found = False
        for c in cm[u]:
            if not any(i.worker == w for i in by_node.get(c, ())):
                continue
            ib = dag.meta.get(c, {}).get("in_boxes")
            if ib is None:
                return None
            # a consumer may read the same producer through several slots
            # (duplicate parent edges — e.g. a residual add of one tensor,
            # or glue concatenating two windows of one tile); the hull must
            # cover *every* slot's window, not just the first match
            for slot, p in enumerate(pm[c]):
                if p != u:
                    continue
                box = ib[slot]
                if box is None:
                    return None
                found = True
                if hull is None:
                    hull = list(box)
                else:
                    hull = [
                        (min(a, lo), max(b, hi))
                        for (a, b), (lo, hi) in zip(hull, box)
                    ]
        if not found or hull is None:
            return None
        return tuple(hull)

    # want list: every (input, worker) pair some instance will need from
    # remote — i.e. the input is not computed earlier on that worker's own
    # sub-schedule.  Wants move to ``shippable`` the moment the producer
    # first materializes anywhere and are shipped in the next comm round.
    wants_by_node: Dict[str, List[int]] = {}
    produced: Set[str] = set()
    shippable: List[Tuple[str, int]] = []
    if lookahead:
        want_seen: Set[Tuple[str, int]] = set()
        for w in range(m):
            local_before: Set[str] = set()
            for inst in subs[w]:
                for u in pm[inst.node]:
                    if u not in local_before and (u, w) not in want_seen:
                        want_seen.add((u, w))
                        wants_by_node.setdefault(u, []).append(w)
                local_before.add(inst.node)

    def mark_produced(node: str) -> None:
        if node not in produced:
            produced.add(node)
            for w in wants_by_node.pop(node, ()):  # noqa: B909 (pop is safe)
                shippable.append((node, w))

    n_left = sum(len(s) for s in subs)
    steps: List[Superstep] = []
    guard = 0
    while n_left:
        guard += 1
        if guard > 10 * (len(dag.nodes) * m + 1):
            raise RuntimeError("plan construction did not converge (invalid schedule?)")
        # ---- compute phase -------------------------------------------- #
        segs: List[List[str]] = [[] for _ in range(m)]
        progress = True
        while progress:
            progress = False
            for w in range(m):
                sub = subs[w]
                while heads[w] < len(sub):
                    head = sub[heads[w]]
                    if all((u, w) in have for u in pm[head.node]):
                        segs[w].append(head.node)
                        have.add((head.node, w))
                        computed.add((head.node, w))
                        mark_produced(head.node)
                        heads[w] += 1
                        n_left -= 1
                        progress = True
                    else:
                        break
        # ---- comm phase ------------------------------------------------ #
        transfers: List[Transfer] = []
        seen: Set[Tuple[str, int, int]] = set()

        def ship(u: str, w: int) -> None:
            sup = supplier(u)
            if sup is None:
                return  # producer not ready anywhere; next round
            key = (u, sup.worker, w)
            if key not in seen:
                seen.add(key)
                transfers.append(
                    Transfer(node=u, src=sup.worker, dst=w, box=edge_box(u, w))
                )
            have.add((u, w))

        if lookahead:
            # ship every want whose producer materialized this superstep
            for (u, w) in shippable:
                if (u, w) not in have:
                    ship(u, w)
            shippable.clear()
        else:
            for w in range(m):
                if heads[w] >= len(subs[w]):
                    continue
                head = subs[w][heads[w]]
                for u in pm[head.node]:
                    if (u, w) not in have:
                        ship(u, w)
        if not any(segs) and not transfers:
            raise RuntimeError("deadlocked plan: no compute and no transfers")
        steps.append(Superstep(
            compute=tuple(tuple(s) for s in segs),
            transfers=tuple(transfers),
        ))

    sink = sinks[0]
    sink_inst = min(schedule.instances_of(sink), key=lambda i: i.finish(dag))
    return ExecutionPlan(
        n_workers=m,
        steps=tuple(steps),
        makespan=schedule.makespan(dag),
        sink=sink,
        sink_worker=sink_inst.worker,
    )


def coalesce_transfer_steps(plan: ExecutionPlan) -> ExecutionPlan:
    """Merge transfer-only supersteps into the preceding comm round.

    Sliced plans emit rounds where every worker is blocked on remote data
    and no one computes; each such round costs the executor one more
    unrolled superstep (and one more collective) for no compute.  Because
    suppliers are always workers that *computed* the value (build_plan),
    a transfer's source register never depends on an earlier transfer in
    the same or the previous round, so consecutive transfer-only rounds —
    with no compute separating them — collapse into the previous step's
    round soundly.  A defensive relay check keeps the pass safe for
    hand-built plans whose sources received their payload in the round
    being merged into.
    """
    steps: List[Superstep] = []
    for st in plan.steps:
        if steps and not any(st.compute):
            prev = steps[-1]
            received = {(t.node, t.dst) for t in prev.transfers}
            if all((t.node, t.src) not in received for t in st.transfers):
                steps[-1] = Superstep(prev.compute, prev.transfers + st.transfers)
                continue
        steps.append(st)
    if len(steps) == len(plan.steps):
        return plan
    return dataclasses.replace(plan, steps=tuple(steps))


def _permutation_rounds(pairs):
    """Split (src, dst) pairs into rounds where srcs and dsts are unique.

    ``lax.ppermute`` is a strict permutation, so a comm round with repeated
    endpoints (multicasts, fan-ins) is executed as several sub-rounds.  The
    executor lowers comm with this exact split, and the WCET certificate
    prices it with the same split, so the certified bound covers the
    collectives the executor actually emits.
    """
    rounds = []
    remaining = list(pairs)
    while remaining:
        srcs, dsts, this, rest = set(), set(), [], []
        for (s, d) in remaining:
            if s in srcs or d in dsts:
                rest.append((s, d))
            else:
                srcs.add(s)
                dsts.add(d)
                this.append((s, d))
        rounds.append(this)
        remaining = rest
    return rounds


# --------------------------------------------------------------------------- #
# segmented canonicalization: packed registers, uniform ticks, ring rounds
# --------------------------------------------------------------------------- #
def pack_registers(
    plan: ExecutionPlan,
    reg_sizes: Mapping[str, int],
    liveness: Optional[Tuple[Mapping[str, int], Mapping[str, int]]] = None,
) -> Tuple[Dict[str, int], int]:
    """Static element offsets of every register in one packed buffer.

    Returns ``(offsets, total)``: register ``b`` occupies elements
    ``[offsets[b], offsets[b] + reg_sizes[b])`` of a flat per-worker buffer
    of ``total`` elements (per sample; the executor carries ``(batch,
    total)``).  With ``liveness=(birth, death)`` (from ``plan_liveness``),
    a register whose death superstep precedes another's birth superstep may
    donate its slot — exact-size reuse keeps the buffer near the plan's
    working set while every offset stays static, which is what lets the
    scan carry be one fixed array.  Soundness of reuse: computed registers
    are fully written at birth, and transfer-materialized registers are
    read only inside their shipped hull, so a reused slot's stale bytes are
    never observed.  ``liveness=None`` lays registers out densely in first-
    appearance order (no reuse).
    """
    appear: List[str] = []
    seen: Set[str] = set()
    for step in plan.steps:
        for seg in step.compute:
            for n in seg:
                if n not in seen:
                    seen.add(n)
                    appear.append(n)
        for t in step.transfers:
            if t.node not in seen:
                seen.add(t.node)
                appear.append(t.node)
    offsets: Dict[str, int] = {}
    total = 0
    if liveness is None:
        for n in appear:
            offsets[n] = total
            total += int(reg_sizes[n])
        return offsets, total
    birth, death = liveness
    # sweep supersteps; at each step allocate that step's births (first from
    # same-size slots freed at a strictly earlier step), then release the
    # slots of registers dying at this step
    by_birth: Dict[int, List[str]] = {}
    for n in appear:
        by_birth.setdefault(birth[n], []).append(n)
    free: Dict[int, List[Tuple[int, int]]] = {}  # size -> [(freed_step, off)]
    deaths_at: Dict[int, List[str]] = {}
    for n in appear:
        deaths_at.setdefault(death[n], []).append(n)
    for step in range(len(plan.steps) + 1):
        for n in by_birth.get(step, ()):
            sz = int(reg_sizes[n])
            slot = None
            for k, (freed, off) in enumerate(free.get(sz, ())):
                if freed < step:
                    slot = free[sz].pop(k)[1]
                    break
            if slot is None:
                slot = total
                total += sz
            offsets[n] = slot
        for n in deaths_at.get(step, ()):
            free.setdefault(int(reg_sizes[n]), []).append((step, offsets[n]))
    return offsets, total


@dataclasses.dataclass(frozen=True)
class RegisterLayout:
    """Packed register layout of one plan: where every register lives.

    Wraps :func:`pack_registers`' ``(offsets, total)`` together with the
    per-sample register shapes so runtime components (superstep snapshots,
    :func:`migrate_registers`, plan validation) can pack/unpack per-worker
    carry buffers without re-deriving the layout.  Layouts are deterministic
    functions of ``(plan, shapes, liveness)``, so the checkpointing runner,
    the segmented executor and the migration pass all agree on offsets by
    construction.
    """

    offsets: Mapping[str, int]
    total: int
    shapes: Mapping[str, Tuple[int, ...]]

    @staticmethod
    def of(
        plan: "ExecutionPlan",
        reg_shapes: Mapping[str, Tuple[int, ...]],
        liveness: Optional[Tuple[Mapping[str, int], Mapping[str, int]]] = None,
    ) -> "RegisterLayout":
        sizes = {
            n: (int(np.prod(s)) if s else 1) for n, s in reg_shapes.items()
        }
        offsets, total = pack_registers(plan, sizes, liveness=liveness)
        return RegisterLayout(
            offsets=offsets, total=total,
            shapes={n: tuple(reg_shapes[n]) for n in offsets},
        )

    def size(self, node: str) -> int:
        s = self.shapes[node]
        return int(np.prod(s)) if s else 1

    def pack(
        self, regs: Mapping[str, np.ndarray], batch: int
    ) -> np.ndarray:
        """One packed ``(batch, total)`` carry from a register dict.

        Registers absent from ``regs`` (dead or not yet born) leave their
        slot zeroed — matching the executor's zero-initialized carry."""
        buf = np.zeros((batch, self.total), dtype=np.float32)
        for n, v in regs.items():
            off = self.offsets[n]
            buf[:, off:off + self.size(n)] = np.asarray(v).reshape(batch, -1)
        return buf

    def unpack(
        self, buf: np.ndarray, nodes: Sequence[str], batch: int
    ) -> Dict[str, np.ndarray]:
        """Register dict view of selected registers of a packed carry."""
        out: Dict[str, np.ndarray] = {}
        for n in nodes:
            off = self.offsets[n]
            out[n] = np.asarray(buf[:, off:off + self.size(n)]).reshape(
                batch, *self.shapes[n]
            )
        return out


def _computed_before(plan: ExecutionPlan, step: int) -> Dict[str, int]:
    """node -> first worker that computed it in supersteps ``[0, step)``."""
    first: Dict[str, int] = {}
    for s in plan.steps[:step]:
        for w, seg in enumerate(s.compute):
            for n in seg:
                first.setdefault(n, w)
    return first


def plan_computers(plan: ExecutionPlan) -> Dict[str, Tuple[int, ...]]:
    """node -> every worker that computes it somewhere in ``plan``."""
    by: Dict[str, List[int]] = {}
    for s in plan.steps:
        for w, seg in enumerate(s.compute):
            for n in seg:
                ws = by.setdefault(n, [])
                if w not in ws:
                    ws.append(w)
    return {n: tuple(ws) for n, ws in by.items()}


def migrate_registers(
    old_plan: ExecutionPlan,
    new_plan: ExecutionPlan,
    old_layout: RegisterLayout,
    new_layout: RegisterLayout,
    bufs: Sequence[np.ndarray],
    step: int,
) -> Tuple[List[np.ndarray], Set[str], Dict[str, object]]:
    """Remap a superstep-boundary snapshot into a replanned plan's layout.

    ``bufs`` is the barrier snapshot entering ``old_plan`` superstep
    ``step``: one packed ``(batch, old_total)`` carry per old worker, in
    ``old_layout``.  Every value computed in supersteps ``[0, step)`` is
    remapped by ``(node, window box)`` into ``new_plan``'s register layout:
    the *full* value lives at its computing worker's old offset (computed
    registers are fully written at birth — the :func:`pack_registers`
    soundness invariant), and it is seeded at the new offset on every new
    worker that ``new_plan`` assigns to compute it.  Windowed transfer
    materializations (destination registers holding only a shipped hull)
    are deliberately *not* migrated: the new plan's own comm rounds re-ship
    exactly the hulls its consumers read, from the seeded computers, so
    resumed windows are re-established by construction instead of being
    remapped across incompatible worker sets.

    Slot reuse makes a subtlety explicit: a completed register whose old
    slot was donated to a later birth holds stale bytes at the barrier.
    That is safe to migrate — its death preceding ``step`` means every one
    of its consumers is itself completed (and therefore skipped on resume),
    so the stale bytes are never read; they are still seeded so the resumed
    plan's structure (its transfers of that register) stays executable.

    Returns ``(new_bufs, completed, stats)``: per-new-worker packed carries,
    the set of node names the resumed execution may skip recomputing, and
    migration cost counters (``migrated_bytes``, ``placements``).
    """
    m_new = new_plan.n_workers
    batch = int(bufs[0].shape[0]) if bufs else 1
    completed = _computed_before(old_plan, step)
    new_computes = plan_computers(new_plan)
    new_bufs = [
        np.zeros((batch, new_layout.total), dtype=np.float32)
        for _ in range(m_new)
    ]
    migrated = 0
    placements = 0
    for node, src_w in completed.items():
        size = old_layout.size(node)
        assert size == new_layout.size(node), (
            f"register {node} changes size across plans "
            f"({size} vs {new_layout.size(node)})"
        )
        o_off = old_layout.offsets[node]
        val = bufs[src_w][:, o_off:o_off + size]
        n_off = new_layout.offsets[node]
        for w in new_computes.get(node, ()):
            new_bufs[w][:, n_off:n_off + size] = val
            placements += 1
            migrated += val.size * 4
    return new_bufs, set(completed), {
        "migrated_bytes": migrated,
        "placements": placements,
        "completed_nodes": len(completed),
        "resumed_from_step": step,
    }


# --------------------------------------------------------------------------- #
# WCET certificates: per-superstep worst-case bounds from the cost model
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class WCETCertificate:
    """Per-superstep worst-case execution bounds of one plan.

    The paper certifies generated code with per-layer OTAWA WCETs; here the
    same role is played by the roofline cost model (the DAG's ``t``/``w``
    annotations).  A plan executes as barrier-synchronized supersteps, so
    its certified bound is, per superstep,

        compute_bound = max over workers of the sum of t(v) in its segment
        comm_bound    = sum over permutation sub-rounds of the slowest
                        (src, dst) pair's payload time

    — the exact shape the MPMD executor lowers (one switch dispatch per
    worker, one collective per permutation round).  ``margin`` is a safety
    derating multiplier applied on top.  All bounds are in the DAG's time
    unit, so they compare directly with the scheduler's makespan and with
    :class:`~repro.runtime.elastic.HealthMonitor` step timings.
    """

    compute_bounds: Tuple[float, ...]
    comm_bounds: Tuple[float, ...]
    margin: float = 1.0
    hw_name: str = ""

    @property
    def step_bounds(self) -> Tuple[float, ...]:
        return tuple(
            (c + x) * self.margin
            for c, x in zip(self.compute_bounds, self.comm_bounds)
        )

    @property
    def total(self) -> float:
        return float(sum(self.step_bounds))

    @property
    def n_steps(self) -> int:
        return len(self.compute_bounds)

    def bound(self, step: int) -> float:
        return self.step_bounds[step]

    def overruns(
        self, timings: Sequence[Tuple[int, float]], slack: float = 1.0
    ) -> List[Tuple[int, float]]:
        """(step, measured) pairs exceeding ``slack`` x the step's bound."""
        return [
            (s, dt) for (s, dt) in timings
            if 0 <= s < self.n_steps and dt > slack * self.bound(s)
        ]


def wcet_certificate(
    plan: ExecutionPlan,
    dag: "DAG",
    out_bytes: Mapping[str, float],
    hw=None,
    time_unit: float = 1e-6,
    margin: float = 1.0,
    comm_time=None,
    batch: int = 1,
) -> WCETCertificate:
    """Emit the plan's per-superstep worst-case bounds from the cost model.

    ``dag.t`` must be the per-node WCET analogue the schedule was built
    from (the roofline costs in ``time_unit`` seconds, or OTAWA cycles for
    the paper's tables).  Communication is priced per permutation sub-round
    from transfer payload bytes: a windowed transfer contributes its hull
    (``Transfer.box_bytes``), a whole-register transfer ``out_bytes[node]``,
    and per-pair payloads within a sub-round overlap, so the round's bound
    is its slowest pair.  ``comm_time(bytes) -> dag-time-units`` overrides
    the default ``hw.comm_time(bytes) / time_unit`` pricing (the paper's
    cycles-per-byte calibration uses this hook).
    """
    if comm_time is None:
        if hw is None:
            raise ValueError(
                "wcet_certificate needs a HardwareSpec (hw=) or an explicit "
                "comm_time(bytes) pricing function for the comm bounds"
            )
        comm_time = lambda b: hw.comm_time(b) / time_unit  # noqa: E731

    def t_bytes(t: Transfer) -> float:
        b = t.box_bytes()
        return float(out_bytes[t.node] if b is None else b) * batch

    compute_bounds: List[float] = []
    comm_bounds: List[float] = []
    for s in plan.steps:
        compute_bounds.append(max(
            (sum(dag.t[n] for n in seg) for seg in s.compute), default=0.0
        ))
        pair_bytes: Dict[Tuple[int, int], float] = {}
        for t in s.transfers:
            pair_bytes[(t.src, t.dst)] = (
                pair_bytes.get((t.src, t.dst), 0.0) + t_bytes(t)
            )
        bound = 0.0
        for round_pairs in _permutation_rounds(sorted(pair_bytes)):
            bound += max(comm_time(pair_bytes[p]) for p in round_pairs)
        comm_bounds.append(bound)
    return WCETCertificate(
        compute_bounds=tuple(compute_bounds),
        comm_bounds=tuple(comm_bounds),
        margin=margin,
        hw_name=getattr(hw, "name", "") if hw is not None else "custom",
    )


@dataclasses.dataclass(frozen=True)
class CommRound:
    """One ring-shift comm round of a segment's uniform schema.

    Every tick of the segment executes the full static permutation
    ``(w, (w + delta) % n_workers)``; what each pair ships is data, not
    trace structure: ``rows`` holds the deduplicated gather/scatter index
    rows (absolute element positions in the packed buffer, padded to
    ``length`` with ``pad_index``), and ``slot[tick][dst]`` picks the row
    describing what ``dst`` receives at that tick (row 0 is the all-padding
    row for inactive (tick, dst) cells).  Because a register has the same
    offset on every worker, one row serves both ends of a pair: the source
    gathers the row of its destination, the destination scatters its own.
    """

    delta: int
    length: int
    rows: np.ndarray   # (n_rows, length) int32; rows[0] all pad_index
    slot: np.ndarray   # (n_ticks, n_workers) int32 -> row id


@dataclasses.dataclass(frozen=True)
class SegmentStaging:
    """Staging-strip allocation of one segment's comm payload blocks.

    Every tick's active ring rounds land their concatenated payload as one
    ``dynamic_update_slice`` block in the packed carry past the dump
    column; this layout decides *where*.  ``buffer_depth == 1`` is the
    write-once layout: every shipping tick gets a private strip, allocated
    tick-major across the whole plan, so delivered values are never
    clobbered (carry width grows with the total fire count).
    ``buffer_depth >= 2`` is the **streaming** layout: ``buffer_depth``
    rotating frames of ``frame_elems`` columns each (the largest per-tick
    payload anywhere in the plan), and shipping tick ``g`` (globally
    counted) lands in frame ``g % buffer_depth`` — superstep ``k+1``'s
    fires land while tick ``k``'s deliveries are still being consumed, and
    a frame is only reclaimed ``buffer_depth`` shipping ticks later, when
    the executor has retired its still-live occupants back to their packed
    register columns.  Staging memory is then bounded by
    ``buffer_depth * frame_elems`` instead of the total fire count.

    All columns are absolute packed-buffer positions: ``stage_base`` is the
    first staging column (``pad_index + 1``), ``stage_end`` the first
    column past the staging region (covers every tick's block plus its
    self-restoring tail).  Idle ticks of a rounds-bearing segment point
    their (value-preserving) read-back block at ``stage_base``.
    """

    buffer_depth: int
    stage_base: int
    frame_elems: int     # rotating frame width (0 when buffer_depth == 1)
    stage_end: int
    act: np.ndarray      # (n_ticks, n_rounds) bool — round fires at tick
    soff: np.ndarray     # (n_ticks, n_rounds) int32 — round's strip column
    base: np.ndarray     # (n_ticks,) int32 — tick's payload block base
    payloads: np.ndarray  # (n_ticks,) int32 — total active length per tick
    frame_of: np.ndarray  # (n_ticks,) int32 — rotating frame id (-1 idle
    #                       tick or buffer_depth == 1)

    @property
    def lmax(self) -> int:
        """Widest per-tick payload block (the pattern-switch pad width)."""
        return int(self.payloads.max()) if self.payloads.size else 0


@dataclasses.dataclass(frozen=True)
class PlanSegment:
    """A run of supersteps lowered to one uniform scan schema.

    ``ticks[t][w]`` is the node worker ``w`` computes at tick ``t`` (``None``
    = idle); each superstep contributes ``max_w len(compute[w])`` ticks (at
    least one) and its comm round fires on the step's final tick.  ``rounds``
    is the segment's fixed set of ring rounds (see :class:`CommRound`);
    ``stage`` places each tick's landed payload block in the packed carry
    (see :class:`SegmentStaging` — write-once or rotating, by
    ``buffer_depth``).
    """

    start: int   # first plan superstep (inclusive)
    stop: int    # past-last plan superstep
    ticks: Tuple[Tuple[Optional[str], ...], ...]
    step_of_tick: Tuple[int, ...]
    rounds: Tuple[CommRound, ...]
    stage: Optional[SegmentStaging] = None


def _box_positions(
    off: int, shape: Sequence[int], box: Optional[Box]
) -> np.ndarray:
    """Absolute packed-buffer element positions of a register window.

    ``box`` axes align with the leading per-sample axes of ``shape``
    (trailing axes unboxed = full), exactly like the executor's
    ``_box_index``."""
    size = int(np.prod(shape)) if shape else 1
    if box is None:
        return np.arange(off, off + size, dtype=np.int64)
    full = [(0, int(s)) for s in shape]
    for k, (lo, hi) in enumerate(box):
        full[k] = (int(lo), int(hi))
    grids = np.meshgrid(
        *[np.arange(lo, hi) for (lo, hi) in full], indexing="ij"
    )
    flat = np.ravel_multi_index(
        [g.reshape(-1) for g in grids], tuple(int(s) for s in shape)
    )
    return flat.astype(np.int64) + off


def _step_round_positions(
    step: Superstep,
    reg_shapes: Mapping[str, Tuple[int, ...]],
    offsets: Mapping[str, int],
    m: int,
) -> Dict[int, Dict[int, np.ndarray]]:
    """delta -> dst worker -> concatenated window positions of one round."""
    out: Dict[int, Dict[int, List[np.ndarray]]] = {}
    for t in step.transfers:
        delta = (t.dst - t.src) % m
        pos = _box_positions(offsets[t.node], reg_shapes[t.node], t.box)
        out.setdefault(delta, {}).setdefault(t.dst, []).append(pos)
    return {
        d: {w: np.concatenate(chunks) for w, chunks in dsts.items()}
        for d, dsts in out.items()
    }


def build_segments(
    plan: ExecutionPlan,
    reg_shapes: Mapping[str, Tuple[int, ...]],
    offsets: Mapping[str, int],
    pad_index: int,
    split_ratio: float = 16.0,
    cohort_ratio: Optional[float] = 4.0,
    buffer_depth: int = 1,
) -> List[PlanSegment]:
    """Canonicalize ``plan`` into uniformly-shaped :class:`PlanSegment`\\ s.

    Supersteps are expanded into ticks (one node per worker per tick) and
    grouped greedily: a new segment starts when a step's largest comm-round
    payload differs from the running segment's by more than ``split_ratio``
    in either direction — merging those would pad every tick of the segment
    to the outlier's length, while splitting only re-traces the boundary's
    compute signatures once more.  Within a segment every tick executes the
    same static program (one switch dispatch + the segment's ring rounds);
    all per-tick variation lives in the index/descriptor tables.

    Ring rounds are sized per **tick cohort**, not per segment: for each
    ring delta, the ticks that actually ship bytes are grouped into cohorts
    whose largest and smallest per-destination payloads differ by at most
    ``cohort_ratio``, and each cohort becomes its own :class:`CommRound`
    padded only to the *cohort* max (``cohort_ratio=None`` restores one
    segment-max round per delta — the pre-cohort layout, kept as an
    ablation/debug knob).  Rounds that would ship nothing anywhere — fully
    padded, e.g. every payload of a delta empty — are elided here at build
    time instead of surviving as runtime ``lax.cond``-skipped rounds:
    every emitted round has ``length >= 1`` and at least one active
    ``(tick, dst)`` cell.

    ``buffer_depth`` selects the staging layout attached as each segment's
    ``stage`` (see :class:`SegmentStaging`): 1 (default) is the write-once
    tick-major allocation, 2/4 double/quad-buffer the comm landing area as
    rotating frames so staging memory stays bounded and superstep ``k+1``'s
    fires can land under tick ``k``'s still-pending reads.
    """
    if not (isinstance(buffer_depth, int) and buffer_depth >= 1):
        raise ValueError(
            f"buffer_depth must be a positive int (1 = write-once staging, "
            f">= 2 = rotating frames), got {buffer_depth!r}"
        )
    m = plan.n_workers
    per_step = []
    for i, step in enumerate(plan.steps):
        rounds = _step_round_positions(step, reg_shapes, offsets, m)
        scale = max(
            (len(p) for dsts in rounds.values() for p in dsts.values()),
            default=0,
        )
        per_step.append((i, step, rounds, scale))

    groups: List[List[int]] = []
    seg_scale = 0  # largest payload of the running segment (0 = none yet)
    for i, _step, _rounds, scale in per_step:
        split = (
            groups
            and scale
            and seg_scale
            and max(scale, seg_scale) > split_ratio * min(scale, seg_scale)
        )
        if not groups or split:
            groups.append([i])
            seg_scale = scale
        else:
            groups[-1].append(i)
            seg_scale = max(seg_scale, scale)
    segments: List[PlanSegment] = []
    for grp in groups:
        ticks: List[Tuple[Optional[str], ...]] = []
        step_of_tick: List[int] = []
        comm_at: List[Tuple[int, Dict[int, Dict[int, np.ndarray]]]] = []
        for i in grp:
            step = plan.steps[i]
            n_ticks = max(max((len(s) for s in step.compute), default=0), 1)
            for j in range(n_ticks):
                ticks.append(tuple(
                    seg[j] if j < len(seg) else None for seg in step.compute
                ))
                step_of_tick.append(i)
            comm_at.append((len(ticks) - 1, per_step[i][2]))
        n_ticks = len(ticks)
        deltas = sorted({d for (_t, rnds) in comm_at for d in rnds})
        rounds: List[CommRound] = []
        for delta in deltas:
            # shipping ticks only, empty payloads dropped: a (tick, dst)
            # with nothing to ship must become an inactive slot-0 cell, and
            # a delta whose payloads are all empty must not emit a round
            ship = []
            for (t, rnds) in comm_at:
                dsts = {
                    w: p for w, p in rnds.get(delta, {}).items() if len(p)
                }
                if dsts:
                    ship.append((t, dsts))
            if not ship:
                continue  # all-sentinel round: elided at build time
            # cohorts of ticks with similar payload scale, each padded to
            # its own max — ascending, so a cohort's spread is bounded by
            # its first (smallest) member
            ship.sort(key=lambda td: max(len(p) for p in td[1].values()))
            cohorts: List[List] = []
            floor = 0
            for t, dsts in ship:
                sc = max(len(p) for p in dsts.values())
                if cohort_ratio is not None and (
                    not cohorts or sc > cohort_ratio * floor
                ):
                    cohorts.append([])
                    floor = sc
                elif not cohorts:
                    cohorts.append([])
                cohorts[-1].append((t, dsts))
            for members in cohorts:
                length = max(
                    len(p) for (_t, dsts) in members for p in dsts.values()
                )
                pad_row = np.full((length,), pad_index, dtype=np.int32)
                rows: List[np.ndarray] = [pad_row]
                row_ids: Dict[bytes, int] = {pad_row.tobytes(): 0}
                slot = np.zeros((n_ticks, m), dtype=np.int32)
                for (t, dsts) in members:
                    for dst, pos in dsts.items():
                        row = np.full((length,), pad_index, dtype=np.int32)
                        row[: len(pos)] = pos.astype(np.int32)
                        # source gather and destination scatter consume the
                        # same row, so any lane order is sound — sort it
                        # (pad_index is the maximum, so padding lands at the
                        # tail) to let the executor mark its gathers/scatters
                        # indices_are_sorted
                        row = np.sort(row)
                        rid = row_ids.setdefault(row.tobytes(), len(rows))
                        if rid == len(rows):
                            rows.append(row)
                        slot[t, dst] = rid
                rounds.append(CommRound(
                    delta=delta, length=length,
                    rows=np.stack(rows), slot=slot,
                ))
        segments.append(PlanSegment(
            start=grp[0], stop=grp[-1] + 1,
            ticks=tuple(ticks), step_of_tick=tuple(step_of_tick),
            rounds=tuple(rounds),
        ))
    return _allocate_staging(segments, pad_index, buffer_depth)


def _allocate_staging(
    segments: List[PlanSegment], pad_index: int, buffer_depth: int
) -> List[PlanSegment]:
    """Attach a :class:`SegmentStaging` to every segment.

    Pass 1 derives each segment's per-tick active-round mask and payload
    totals (a round fires at a tick iff any destination holds a non-pad
    slot row there); pass 2 assigns every shipping tick's landing block —
    monotonically for ``buffer_depth == 1`` (write-once strips, the
    frame_elems-free layout whose width grows with the plan's fire count)
    or round-robin over ``buffer_depth`` frames sized to the globally
    largest tick payload.  The executor consumes these columns verbatim,
    so the allocation — not the executor walk — is the single source of
    truth for where delivered values live.
    """
    stage_base = pad_index + 1
    acts: List[np.ndarray] = []
    pays: List[np.ndarray] = []
    for seg in segments:
        n_ticks = len(seg.ticks)
        act = (
            np.stack(
                [(np.asarray(r.slot) != 0).any(axis=1) for r in seg.rounds],
                axis=1,
            )
            if seg.rounds else np.zeros((n_ticks, 0), bool)
        )
        lens = np.asarray([r.length for r in seg.rounds], np.int64)
        pay = (
            (act * lens[None, :]).sum(axis=1).astype(np.int32)
            if seg.rounds else np.zeros(n_ticks, np.int32)
        )
        acts.append(act)
        pays.append(pay)
    frame_elems = (
        max([0] + [int(p.max()) for p in pays if p.size])
        if buffer_depth > 1 else 0
    )
    out: List[PlanSegment] = []
    off = stage_base   # next write-once strip (buffer_depth == 1)
    g = 0              # global shipping-tick counter (buffer_depth >= 2)
    tail_end = stage_base
    for seg, act, pay in zip(segments, acts, pays):
        n_ticks = len(seg.ticks)
        soff = np.zeros((n_ticks, len(seg.rounds)), np.int32)
        base = np.full(n_ticks, stage_base, np.int32)
        frame_of = np.full(n_ticks, -1, np.int32)
        lmax = int(pay.max()) if pay.size else 0
        for t in range(n_ticks):
            if buffer_depth == 1:
                base[t] = off
                for r_i in np.nonzero(act[t])[0]:
                    soff[t, r_i] = off
                    off += seg.rounds[r_i].length
            elif pay[t]:
                frame_of[t] = g % buffer_depth
                base[t] = stage_base + frame_of[t] * frame_elems
                g += 1
                o = int(base[t])
                for r_i in np.nonzero(act[t])[0]:
                    soff[t, r_i] = o
                    o += seg.rounds[r_i].length
            # idle ticks of a rounds-bearing segment read back (and
            # rewrite unchanged) lmax columns at their base — keep that
            # block in bounds
            tail_end = max(tail_end, int(base[t]) + lmax)
        out.append(dataclasses.replace(seg, stage=SegmentStaging(
            buffer_depth=buffer_depth,
            stage_base=stage_base,
            frame_elems=frame_elems,
            stage_end=0,  # patched below once the global extent is known
            act=act, soff=soff, base=base, payloads=pay, frame_of=frame_of,
        )))
    stage_end = max(
        tail_end,
        off if buffer_depth == 1
        else stage_base + buffer_depth * frame_elems,
    )
    return [
        dataclasses.replace(
            s, stage=dataclasses.replace(s.stage, stage_end=stage_end)
        )
        for s in out
    ]


def plan_summary(plan: ExecutionPlan, dag: DAG) -> Dict[str, object]:
    """Slice-aware plan statistics, grouped by originating layer.

    Uses the DAG's node metadata (``origin``) so operator-granularity plans
    report per-*layer* compute/transfer distribution rather than thousands of
    per-tile rows.  For layer-granularity DAGs origins are the nodes
    themselves.
    """
    compute_by_origin: Dict[str, int] = {}
    for step in plan.steps:
        for seg in step.compute:
            for n in seg:
                o = dag.origin(n)
                compute_by_origin[o] = compute_by_origin.get(o, 0) + 1
    transfers_by_origin: Dict[str, int] = {}
    for step in plan.steps:
        for t in step.transfers:
            o = dag.origin(t.node)
            transfers_by_origin[o] = transfers_by_origin.get(o, 0) + 1
    return {
        "supersteps": len(plan.steps),
        "transfers": plan.n_transfers,
        "origins": len(compute_by_origin),
        "compute_by_origin": compute_by_origin,
        "transfers_by_origin": transfers_by_origin,
        "max_transfers_per_origin": max(transfers_by_origin.values(), default=0),
    }
