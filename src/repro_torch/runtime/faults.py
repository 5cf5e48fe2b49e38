"""Deterministic fault injection + superstep checkpoint/replan/resume.

The paper's deployment target is a safety-critical multi-core, where a
schedule is judged by its behaviour under degraded hardware as much as by
its makespan.  This module gives the sliced-plan pipeline a failure story:

* :class:`FaultPlan` — seeded, replayable fault campaigns.  A campaign is
  pure data (worker death at superstep ``k``, straggler slowdown, dropped
  transfer round), so every drill is exactly reproducible from its seed:
  the same campaign can be re-run against a fixed plan, a replanned plan,
  or a future executor and must produce the same injections.
* :func:`run_with_faults` — a superstep-resolution runner with the same
  semantics as ``interpret_plan`` plus barrier snapshots: entering every
  superstep it packs the per-worker register state through a
  :class:`~repro_torch.codegen.plan.RegisterLayout` — the same packed carry the
  segmented executor's ``checkpoint=True`` mode returns at segment
  boundaries.  Faults are injected at superstep boundaries: a **kill**
  interrupts the superstep (its partial results are lost; the runner
  returns the barrier snapshot *entering* it, so recovery re-executes at
  most that one superstep); a **straggle** inflates the victim's simulated
  step time (feeding :class:`~repro_torch.runtime.elastic.HealthMonitor`); a
  **drop_round** retransmits the superstep's comm round, charging the
  retransmission bytes to the recovery bill without corrupting state
  (the executor's collectives are reliable; the drop models the
  paper's Writing/Reading retry, not silent data loss).
* :func:`resume_plan` — continue a (re)plan with completed computes
  skipped, after :func:`~repro_torch.codegen.plan.migrate_registers` seeded the
  new layout from the old barrier snapshot.
* :func:`kill_and_resume_drill` — the end-to-end headline: run sliced,
  kill a worker mid-run, detect via heartbeats, replan to m−1 through the
  full validated pipeline, migrate, resume; the final output must be
  allclose to ``run_sequential`` and the recovery cost (recomputed
  supersteps, migrated bytes, replan ms) is reported.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.codegen.executor import _box_index, _Workers
from repro_torch.codegen.plan import (
    ExecutionPlan,
    RegisterLayout,
    Transfer,
    coalesce_transfer_steps,
    build_plan,
    migrate_registers,
    plan_computers,
)
from repro_torch.runtime.elastic import ElasticPlanner, HealthMonitor

__all__ = [
    "FaultEvent",
    "FaultPlan",
    "RunOutcome",
    "run_with_faults",
    "resume_plan",
    "kill_and_resume_drill",
]

FAULT_KINDS = ("kill", "straggle", "drop_round")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault at a superstep boundary.

    ``kind`` ∈ ``kill`` (worker dies during superstep ``step``),
    ``straggle`` (worker's simulated time for ``step`` onward is multiplied
    by ``factor``), ``drop_round`` (superstep ``step``'s comm round is
    transmitted twice; the first copy is "lost").
    """

    kind: str
    step: int
    worker: int
    factor: float = 4.0  # straggle slowdown multiplier

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A replayable fault campaign: an ordered tuple of events plus the
    seed that generated it (kept for reporting; the events alone replay)."""

    events: Tuple[FaultEvent, ...]
    seed: Optional[int] = None

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def first_kill(self) -> Optional[FaultEvent]:
        kills = [e for e in self.events if e.kind == "kill"]
        return min(kills, key=lambda e: e.step) if kills else None

    @staticmethod
    def single_kill(step: int, worker: int) -> "FaultPlan":
        return FaultPlan(events=(FaultEvent("kill", step, worker),))

    @staticmethod
    def random(
        n_workers: int,
        n_steps: int,
        seed: int,
        p_kill: float = 0.15,
        p_straggle: float = 0.15,
        p_drop: float = 0.15,
    ) -> "FaultPlan":
        """Seeded campaign: per superstep boundary, independently draw at
        most one fault.  Deterministic function of its arguments — the
        replay contract every drill and regression test relies on."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for step in range(n_steps):
            u = rng.random()
            worker = int(rng.integers(n_workers))
            factor = float(2.0 + 6.0 * rng.random())
            if u < p_kill:
                events.append(FaultEvent("kill", step, worker))
                break  # a dead worker ends the campaign's run
            elif u < p_kill + p_straggle:
                events.append(FaultEvent("straggle", step, worker, factor))
            elif u < p_kill + p_straggle + p_drop:
                events.append(FaultEvent("drop_round", step, worker))
        return FaultPlan(events=tuple(events), seed=seed)


@dataclasses.dataclass
class RunOutcome:
    """Result of a (possibly interrupted) superstep run.

    ``status`` is ``"ok"`` or ``"killed"``.  ``snapshots[k]`` is the packed
    per-worker carry *entering* superstep ``k`` (only retained barriers are
    present; the final barrier after the last superstep is ``snapshots[
    n_steps]``).  On a kill, ``fault`` is the event and ``snapshot`` the
    barrier entering the interrupted superstep — the restore point.
    """

    status: str
    output: Optional[np.ndarray]
    snapshots: Dict[int, List[np.ndarray]]
    fault: Optional[FaultEvent] = None
    step: Optional[int] = None
    retransmitted_bytes: float = 0.0
    straggled: Dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def snapshot(self) -> Optional[List[np.ndarray]]:
        return None if self.step is None else self.snapshots.get(self.step)


def _step_compute_times(plan: ExecutionPlan, dag) -> List[List[float]]:
    """Per-superstep per-worker simulated compute time from ``dag.t``."""
    out = []
    for s in plan.steps:
        out.append([
            float(sum(dag.t[n] for n in seg)) for seg in s.compute
        ])
    return out


def _round_bytes(step, out_bytes: Mapping[str, float]) -> float:
    total = 0.0
    for t in step.transfers:
        b = t.box_bytes()
        total += float(out_bytes[t.node]) if b is None else float(b)
    return total


@torch.no_grad()
def run_with_faults(
    plan: ExecutionPlan,
    model,
    params,
    x: torch.Tensor,
    layout: RegisterLayout,
    faults: Optional[FaultPlan] = None,
    monitor: Optional[HealthMonitor] = None,
    dag=None,
    skip: Optional[Set[str]] = None,
    init_bufs: Optional[Sequence[np.ndarray]] = None,
    keep_snapshots: bool = False,
    worker_ids: Optional[Sequence[int]] = None,
) -> RunOutcome:
    """Execute ``plan`` superstep-by-superstep with barrier snapshots.

    Matches ``interpret_plan`` numerically (same ``apply_layer`` compute,
    same windowed-transfer semantics).  ``skip`` names nodes whose compute
    is elided (their values must be pre-seeded via ``init_bufs``, the
    packed per-worker carries produced by ``migrate_registers``).  With a
    ``monitor`` + ``dag``, per-worker step timings (``dag.t`` units) are
    recorded and heartbeats fed, so detection runs on the same clock as
    the drill.  ``worker_ids`` maps the plan's worker indices onto the
    monitor's worker ids (a replanned m−1 plan numbers its workers
    ``0..m-2`` while the monitor keeps the original fleet's ids; default
    identity).  ``keep_snapshots`` retains every barrier (property tests);
    otherwise barriers are packed only where recovery can need them — at
    injected kill steps and the final barrier — which keeps sustained
    serving traffic from paying a full register-file copy per superstep.

    Registers are tensors on ``x``'s device.  On the card each worker's
    compute segment is issued on its own CUDA stream; the superstep barrier
    joins every stream, and the comm round that follows it runs each
    delivery on its destination's stream.  ``init_bufs`` (numpy) are copied
    to the device once; a snapshot is packed on its worker's stream and
    handed to the host as numpy, as is the output.
    """
    from repro_torch.models.cnn import apply_layer

    skip = skip or set()
    m = plan.n_workers
    if worker_ids is None:
        worker_ids = list(range(m))
    batch = int(x.shape[0])
    dev = x.device
    workers = _Workers(m, dev)
    regs: List[Dict[str, torch.Tensor]] = [dict() for _ in range(m)]
    # registers the comm rounds made on their worker: box writes land in
    # place there, anywhere else (a computed value, a view of ``x`` or of a
    # seeded carry) on a copy
    owned: List[Set[str]] = [set() for _ in range(m)]
    workers.barrier()  # x and params were made on the calling stream
    if init_bufs is not None:
        computers = plan_computers(plan)
        for w in range(m):
            mine = [n for n in skip if w in computers.get(n, ())]
            with workers.on(w):
                buf = torch.from_numpy(
                    np.ascontiguousarray(init_bufs[w], dtype=np.float32)).to(dev)
                regs[w].update(_unpack(layout, buf, mine, batch))
    step_times = _step_compute_times(plan, dag) if dag is not None else None
    out_bytes = {n: layout.size(n) * 4.0 for n in layout.offsets}
    slow: Dict[int, float] = {}
    retrans = 0.0
    snapshots: Dict[int, List[np.ndarray]] = {}
    kill_steps = (
        {e.step for e in faults.events if e.kind == "kill"}
        if faults is not None else set()
    )

    def barrier(k: int, needed: bool) -> None:
        if not (keep_snapshots or needed):
            return
        snap = []
        for w in range(m):
            with workers.on(w):
                snap.append(_pack(layout, regs[w], batch, dev).cpu().numpy())
        if not keep_snapshots:
            snapshots.clear()
        snapshots[k] = snap

    for i, step in enumerate(plan.steps):
        barrier(i, needed=i in kill_steps)
        events = faults.at(i) if faults is not None else ()
        kill = next((e for e in events if e.kind == "kill"), None)
        if kill is not None:
            # the victim dies mid-superstep: this superstep's results are
            # lost; the barrier entering it is the restore point.  The
            # survivors keep heartbeating while stalled at the barrier.
            if monitor is not None:
                for w in range(m):
                    if w != kill.worker:
                        monitor.heartbeat(worker_ids[w])
            workers.barrier()
            return RunOutcome(
                status="killed", output=None, snapshots=snapshots,
                fault=kill, step=i, retransmitted_bytes=retrans,
                straggled=slow,
            )
        for e in events:
            if e.kind == "straggle":
                slow[e.worker] = max(slow.get(e.worker, 1.0), e.factor)
        for w, seg in enumerate(step.compute):
            todo = [n for n in seg if n not in skip]
            if not todo:
                continue
            with workers.on(w):
                for name in todo:
                    spec = model.spec(name)
                    ins = (
                        [x] if spec.op == "input"
                        else [regs[w][p] for p in spec.inputs]
                    )
                    regs[w][name] = apply_layer(spec, params, ins)
                    owned[w].discard(name)
        workers.barrier()
        sends = 1
        if any(e.kind == "drop_round" for e in events):
            sends = 2  # first transmission lost; retry re-ships the round
            retrans += _round_bytes(step, out_bytes) * batch
        for _ in range(sends):
            _comm_round(step.transfers, regs, owned, workers)
            workers.barrier()
        if monitor is not None and step_times is not None:
            dts = [
                step_times[i][w] * slow.get(w, 1.0) for w in range(m)
            ]
            for w in range(m):
                monitor.record_step(i, dts[w], worker=worker_ids[w])
            monitor.advance(max(dts) if dts else 0.0)
    barrier(len(plan.steps), needed=True)
    with workers.on(plan.sink_worker):
        y = regs[plan.sink_worker][plan.sink].cpu().numpy()
    workers.barrier()
    return RunOutcome(
        status="ok", output=y, snapshots=snapshots,
        retransmitted_bytes=retrans, straggled=slow,
    )


def _comm_round(
    transfers: Sequence[Transfer],
    regs: List[Dict[str, torch.Tensor]],
    owned: List[Set[str]],
    workers: _Workers,
) -> None:
    """One comm round after the barrier, each delivery on its destination's
    stream.  Every transfer reads its source's pre-round value: a register
    that is also a source of this round is replaced, never written in place.
    A whole transfer copies (the destination never aliases the source); a
    windowed one writes its box into the destination's register, born zero
    when the destination does not hold it yet."""
    staged = [(t, regs[t.src][t.node]) for t in transfers]
    read = {(t.src, t.node) for t in transfers}
    fresh: Set[Tuple[int, str]] = set()  # (worker, node) made in this round
    for t, src in staged:
        d = t.dst
        with workers.on(d):
            workers.hand_over(src, d)
            if t.box is None:
                regs[d][t.node] = src.clone()
            else:
                idx = _box_index(t)
                cur = regs[d].get(t.node)
                if cur is None:
                    cur = torch.zeros_like(src)
                elif t.node not in owned[d] or (
                    (d, t.node) in read and (d, t.node) not in fresh
                ):
                    cur = cur.clone()
                cur[idx] = src[idx]
                regs[d][t.node] = cur
        owned[d].add(t.node)
        fresh.add((d, t.node))


def _pack(
    layout: RegisterLayout,
    regs: Mapping[str, torch.Tensor],
    batch: int,
    device: torch.device,
) -> torch.Tensor:
    """``RegisterLayout.pack`` on the device: one ``(batch, total)`` f32
    carry, registers written in ``regs``' order, absent ones left zero."""
    buf = torch.zeros((batch, layout.total), dtype=torch.float32, device=device)
    for n, v in regs.items():
        off = layout.offsets[n]
        buf[:, off:off + layout.size(n)] = v.reshape(batch, -1)
    return buf


def _unpack(
    layout: RegisterLayout,
    buf: torch.Tensor,
    nodes: Sequence[str],
    batch: int,
) -> Dict[str, torch.Tensor]:
    """``RegisterLayout.unpack`` on the device: views of ``buf``."""
    return {
        n: buf[:, layout.offsets[n]:layout.offsets[n] + layout.size(n)].reshape(
            batch, *layout.shapes[n])
        for n in nodes
    }


def resume_plan(
    new_plan: ExecutionPlan,
    model,
    params,
    x,
    new_layout: RegisterLayout,
    new_bufs: Sequence[np.ndarray],
    completed: Set[str],
    monitor: Optional[HealthMonitor] = None,
    dag=None,
    worker_ids: Optional[Sequence[int]] = None,
) -> RunOutcome:
    """Run a migrated plan to completion, skipping completed computes."""
    return run_with_faults(
        new_plan, model, params, x, new_layout,
        skip=set(completed), init_bufs=list(new_bufs),
        monitor=monitor, dag=dag, worker_ids=worker_ids,
    )


def _plan_layout(plan: ExecutionPlan, model) -> RegisterLayout:
    """Liveness-packed layout — the segmented executor's own packing."""
    from repro_torch.codegen.executor import plan_liveness

    shapes = {l.name: tuple(l.out_shape) for l in model.layers}
    birth, death, _sets = plan_liveness(plan, model)
    return RegisterLayout.of(plan, shapes, liveness=(birth, death))


def kill_and_resume_drill(
    model,
    params,
    x,
    dag,
    m: int,
    kill_step: Optional[int] = None,
    kill_worker: int = 0,
    seed: Optional[int] = None,
    heuristic: str = "dsh",
    hw=None,
    validate: bool = True,
) -> Dict[str, object]:
    """Full kill → detect → replan(m−1) → migrate → resume drill.

    ``model``/``dag`` are the *sliced* model and its annotated DAG; the
    drill builds the m-worker plan, injects a deterministic worker death
    (``kill_step``/``kill_worker``, or drawn from ``seed``), detects it
    through :class:`HealthMonitor` heartbeats, replans for the survivors
    through :class:`ElasticPlanner`'s validated sliced pipeline, migrates
    the barrier snapshot with :func:`migrate_registers` and resumes.

    Returns the resumed output plus the recovery bill:
    ``replan_ms`` (wall-clock spent re-scheduling + validating),
    ``migrated_bytes``/``placements`` (migration payload),
    ``recomputed_supersteps`` (always ≤ 1: the interrupted superstep),
    ``recomputed_nodes`` (nodes the survivors recompute), and
    ``detected`` (the monitor's verdict matched the injected fault).
    """
    from repro_torch.core.list_scheduling import dsh, ish

    sched = {"ish": ish, "dsh": dsh}[heuristic](dag, m)
    plan = coalesce_transfer_steps(build_plan(sched, dag))
    if validate:
        from repro_torch.codegen.validate import validate_plan

        validate_plan(plan, dag, model=model)
    n_steps = len(plan.steps)
    if kill_step is None:
        rng = np.random.default_rng(0 if seed is None else seed)
        kill_step = int(rng.integers(1, max(2, n_steps)))
        kill_worker = int(rng.integers(m))
    kill_step = min(kill_step, n_steps - 1)
    faults = FaultPlan.single_kill(kill_step, kill_worker)

    layout = _plan_layout(plan, model)
    monitor = HealthMonitor(m, heartbeat_timeout=30.0)
    for w in range(m):
        monitor.heartbeat(w)
    outcome = run_with_faults(
        plan, model, params, x, layout,
        faults=faults, monitor=monitor, dag=dag,
    )
    assert outcome.status == "killed" and outcome.snapshot is not None

    # detection: the victim's heartbeat goes stale while survivors beat
    monitor.advance(monitor.heartbeat_timeout + 1.0)
    for w in range(m):
        if w != kill_worker:
            monitor.heartbeat(w)
    planner = ElasticPlanner(
        dag, heuristic=heuristic, model=model, hw=hw, validate=validate,
    )
    t0 = time.perf_counter()
    eplan = planner.replan(monitor)
    replan_ms = (time.perf_counter() - t0) * 1e3
    assert eplan.action == "remesh" and eplan.plan is not None
    new_plan = eplan.plan
    detected = monitor.alive_workers() == [
        w for w in range(m) if w != kill_worker
    ]

    new_layout = _plan_layout(new_plan, model)
    new_bufs, completed, mig = migrate_registers(
        plan, new_plan, layout, new_layout, outcome.snapshot, outcome.step,
    )
    resumed = resume_plan(
        new_plan, model, params, x, new_layout, new_bufs, completed,
    )
    assert resumed.status == "ok"
    return {
        "output": resumed.output,
        "old_plan": plan,
        "new_plan": new_plan,
        "certificate": eplan.certificate,
        "kill_step": kill_step,
        "kill_worker": kill_worker,
        "detected": detected,
        "replan_ms": replan_ms,
        "migrated_bytes": mig["migrated_bytes"],
        "placements": mig["placements"],
        "completed_nodes": mig["completed_nodes"],
        "recomputed_supersteps": 1 if kill_step < n_steps else 0,
        "recomputed_nodes": len(dag.nodes) - mig["completed_nodes"],
        "n_steps_old": n_steps,
        "n_steps_new": len(new_plan.steps),
    }
