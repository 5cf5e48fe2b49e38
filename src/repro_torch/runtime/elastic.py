"""Fault tolerance & elasticity runtime (DESIGN §5).

On a real multi-pod deployment every worker process runs this monitor next
to the training loop; here the same logic is driven by a deterministic
simulated clock so the policies are testable on one CPU.

Components
----------
* :class:`HealthMonitor` — heartbeats + per-step timing.  A worker is
  **dead** after ``heartbeat_timeout`` without a beat and a **straggler**
  when its step time exceeds ``straggler_factor`` × the rolling median of
  the fleet (the classic z-ish test used by large-scale trainers).
* :class:`ElasticPlanner` — turns a health verdict into a new plan:
  the surviving worker set is re-meshed, and — this is the paper's loop
  closed — the *same offline DAG scheduler* that produced the original
  m-worker schedule re-solves the problem with ``m' < m`` workers
  (ISH/DSH, §3.3).  Elastic degradation is just "schedule again with fewer
  cores", exactly the ACETONE offline problem.  Given the sliced ``model``
  the planner runs the *full* pipeline the serving path executes — slice
  DAG → ``build_plan`` → ``coalesce_transfer_steps`` → ``validate_plan``
  → WCET certificate — so a degraded plan arrives executable, statically
  checked, and re-certified, ready for :func:`~repro_torch.codegen.plan.
  migrate_registers` to seed it from the last barrier snapshot.
* :func:`simulate_failure_recovery` — end-to-end drill used by tests and
  ``examples/elastic_demo.py``: train, kill a worker, detect, re-plan,
  restore from the latest checkpoint, continue; the loss curve must join.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.graph import DAG
from repro_torch.core.list_scheduling import dsh, ish
from repro_torch.core.schedule import Schedule
from repro_torch.codegen.plan import (
    ExecutionPlan,
    WCETCertificate,
    build_plan,
    coalesce_transfer_steps,
    wcet_certificate,
)

__all__ = [
    "WorkerState",
    "HealthMonitor",
    "ElasticPlan",
    "ElasticPlanner",
    "simulate_failure_recovery",
]


@dataclasses.dataclass
class WorkerState:
    worker_id: int
    last_heartbeat: float = 0.0
    step_times: List[float] = dataclasses.field(default_factory=list)
    # parallel rolling window of (step, dt) pairs — the step index makes
    # deadline overruns attributable to a specific superstep bound
    timings: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    alive: bool = True
    straggler: bool = False


class HealthMonitor:
    """Heartbeat + straggler tracking over a simulated or real clock."""

    def __init__(
        self,
        n_workers: int,
        heartbeat_timeout: float = 30.0,
        straggler_factor: float = 2.0,
        window: int = 16,
    ):
        self.workers = {i: WorkerState(i) for i in range(n_workers)}
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_factor = straggler_factor
        self.window = window
        self.now = 0.0

    # ---- feed ---------------------------------------------------------- #
    def advance(self, dt: float) -> None:
        self.now += dt

    def heartbeat(self, worker: int, t: Optional[float] = None) -> None:
        self.workers[worker].last_heartbeat = self.now if t is None else t

    def record_step(self, step: int, dt: float, worker: int = 0) -> None:
        w = self.workers[worker]
        w.step_times.append(dt)
        w.timings.append((step, dt))
        if len(w.step_times) > self.window:
            w.step_times.pop(0)
        if len(w.timings) > self.window:
            w.timings.pop(0)
        self.heartbeat(worker)

    # ---- verdicts ------------------------------------------------------ #
    def check(
        self,
        certificate: Optional[WCETCertificate] = None,
        slack: float = 1.0,
        commit: bool = True,
    ) -> Dict[str, List[int]]:
        """Health verdicts: ``dead``, ``stragglers`` and — given a WCET
        ``certificate`` — ``deadline`` (workers whose recorded superstep
        timings exceed ``slack`` × the certified per-step bound).

        Death verdicts are decided *first* and the condemned workers'
        stale step timings are excluded from the fleet median — a worker
        that stopped beating minutes ago must not drag the straggler
        baseline toward its last recorded (possibly pathological) times.
        The median test uses ``is not None``: a fleet median of exactly
        0.0 (quantized timers in tests, sub-resolution steps) previously
        disabled straggler detection entirely.

        Verdicts are **stable under repetition**: ``dead`` lists every
        worker currently condemned — both heartbeats that went stale since
        the last check and workers an earlier check already committed
        dead.  (Previously a second ``check()`` returned an empty ``dead``
        list because the first call had flipped ``alive``, so any caller
        running after ``ElasticPlanner.replan`` — whose internal check
        commits the deaths — saw a clean fleet.)  ``commit=False`` makes
        the call fully read-only: the verdict is computed but no
        ``alive``/``straggler`` state is mutated, so a later committing
        check still observes and commits the same deaths.
        """
        dead, stragglers, deadline = [], [], []
        dying = {
            w.worker_id
            for w in self.workers.values()
            if w.alive and self.now - w.last_heartbeat > self.heartbeat_timeout
        }
        medians = [
            statistics.median(w.step_times)
            for w in self.workers.values()
            if w.alive and w.step_times and w.worker_id not in dying
        ]
        fleet_median = statistics.median(medians) if medians else None
        for w in self.workers.values():
            if not w.alive:
                dead.append(w.worker_id)  # sticky: committed by a prior check
                continue
            if w.worker_id in dying:
                if commit:
                    w.alive = False
                dead.append(w.worker_id)
                continue
            is_straggler = (
                fleet_median is not None
                and bool(w.step_times)
                and statistics.median(w.step_times)
                > self.straggler_factor * fleet_median
            )
            if commit:
                w.straggler = is_straggler
            if is_straggler:
                stragglers.append(w.worker_id)
            if certificate is not None and w.timings:
                if certificate.overruns(w.timings, slack=slack):
                    deadline.append(w.worker_id)
        verdict = {"dead": sorted(dead), "stragglers": stragglers}
        if certificate is not None:
            verdict["deadline"] = deadline
        return verdict

    def alive_workers(self) -> List[int]:
        return [w.worker_id for w in self.workers.values() if w.alive]


@dataclasses.dataclass
class ElasticPlan:
    workers: Tuple[int, ...]
    schedule: Optional[Schedule]
    makespan: Optional[float]
    action: str  # "continue" | "remesh" | "exclude_straggler" | "deadline_replan"
    # populated by the sliced pipeline (planner built with ``model``):
    plan: Optional[ExecutionPlan] = None
    certificate: Optional[WCETCertificate] = None


class ElasticPlanner:
    """Re-plans the work distribution when the fleet changes.

    The planner holds the application's task DAG (layer graph, expert
    placement graph, or pipeline-stage graph) and re-runs the ACETONE
    scheduler for the surviving worker count — the paper's offline solver
    reused online as the degraded-mode planner.

    Built with just a ``dag`` it returns a bare :class:`Schedule` (the
    seed-era behaviour).  Built with the sliced ``model`` behind that DAG
    it runs the full executable pipeline: ``build_plan`` →
    ``coalesce_transfer_steps`` → :func:`~repro_torch.codegen.validate.
    validate_plan` with ``deep=True`` (a structurally broken *or
    concurrency-hazardous* replan — data race, missing sync edge,
    frame-reuse WAR, donation clobber — is an exception, never a deployed
    plan; see :mod:`repro_torch.codegen.analyze`) →
    :func:`~repro_torch.codegen.plan.wcet_certificate` (with ``hw``), so every
    degraded plan ships with fresh deadline bounds.
    """

    def __init__(
        self,
        dag: DAG,
        heuristic: str = "dsh",
        model=None,
        hw=None,
        time_unit: float = 1e-6,
        margin: float = 1.0,
        validate: bool = True,
    ):
        self.dag = dag
        self.heuristic = {"ish": ish, "dsh": dsh}[heuristic]
        self.model = model
        self.hw = hw
        self.time_unit = time_unit
        self.margin = margin
        self.validate = validate

    def _finalize(self, workers, sched, action: str) -> ElasticPlan:
        makespan = sched.makespan(self.dag)
        if self.model is None:
            return ElasticPlan(tuple(workers), sched, makespan, action)
        plan = coalesce_transfer_steps(build_plan(sched, self.dag))
        if self.validate:
            from repro_torch.codegen.validate import validate_plan

            # deep=True: structural invariants plus the happens-before
            # hazard analysis (codegen/analyze.py) — a degraded replan
            # with a data race, missing sync edge, or donation hazard is
            # a PlanHazardError here, never a deployed plan
            validate_plan(plan, self.dag, model=self.model, deep=True)
        cert = None
        if self.hw is not None:
            out_bytes = {
                l.name: float(_prod(l.out_shape)) * 4
                for l in self.model.layers
            }
            cert = wcet_certificate(
                plan, self.dag, out_bytes, hw=self.hw,
                time_unit=self.time_unit, margin=self.margin,
            )
        return ElasticPlan(
            tuple(workers), sched, makespan, action,
            plan=plan, certificate=cert,
        )

    def replan(
        self,
        monitor: HealthMonitor,
        exclude_stragglers: bool = False,
        certificate: Optional[WCETCertificate] = None,
        slack: float = 1.0,
        exclude: Sequence[int] = (),
    ) -> ElasticPlan:
        """``exclude`` removes explicit alive workers from the new fleet —
        the caller's own attribution (a WCET-overrunning worker on a
        load-imbalanced sliced plan can be far slower than its share yet
        never cross the cross-fleet median straggler test; a previously
        cordoned worker must stay out of every later replan)."""
        verdict = monitor.check(certificate=certificate, slack=slack)
        workers = monitor.alive_workers()
        action = "continue"
        if verdict["dead"]:
            action = "remesh"
        drop = set(exclude)
        if exclude_stragglers:
            drop |= set(verdict["stragglers"])
        if drop & set(workers):
            workers = [w for w in workers if w not in drop]
            action = "exclude_straggler"
        if action == "continue" and verdict.get("deadline"):
            # the fleet is intact but observed supersteps break the
            # certificate: re-solve so the new plan (and its refreshed
            # bounds) reflect the hardware we actually have
            action = "deadline_replan"
        if not workers:
            raise RuntimeError("no healthy workers remain")
        if action == "continue":
            return ElasticPlan(tuple(workers), None, None, action)
        sched = self.heuristic(self.dag, len(workers))
        return self._finalize(workers, sched, action)


def _prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def simulate_failure_recovery(
    trainer_factory: Callable[[], "object"],
    fail_at_step: int,
    total_steps: int,
    ckpt_every: int,
) -> Dict[str, object]:
    """Kill-and-resume drill.

    1. Train to ``fail_at_step`` with periodic checkpoints, then "crash"
       (drop the trainer object — simulating a pod loss).
    2. Build a fresh trainer (new process semantics), restore the latest
       checkpoint, finish the run.
    Returns both loss histories and the step the resume started from; the
    caller asserts the resumed curve continues (no reset to init loss).
    """
    t1 = trainer_factory()
    t1.ckpt_every = ckpt_every
    t1.run(fail_at_step, log_every=0)
    t1.ckpt.wait()
    hist1 = list(t1.history)
    del t1  # crash

    t2 = trainer_factory()
    t2.ckpt_every = ckpt_every
    resumed = t2.maybe_restore()
    resume_step = t2.step
    t2.run(total_steps - t2.step, log_every=0)
    return {
        "resumed": resumed,
        "resume_step": resume_step,
        "pre_crash": hist1,
        "post_crash": list(t2.history),
    }
