"""Chaos-hardened serving frontend over sliced execution plans.

This is the fold-in of the elastic runtime into serving traffic: the same
validated slice → schedule → execute pipeline that runs single-shot plans
(the checkpoint/replan/resume machinery of ``runtime/faults.py``) driven by a sustained request
stream, with the admission discipline a fail-operational deployment needs:

* **Per-request deadlines with deadline-aware shedding.**  A request whose
  deadline cannot be met (``now + margin × service estimate`` past it) is
  rejected *explicitly* — ``status="shed"``, ``shed_reason="deadline"`` —
  instead of queueing forever.  The service estimate tracks observed run
  times (EWMA over the simulated clock), so a degraded fleet sheds
  earlier, which is the point: predictable rejection beats silent decay.
* **Bounded admission queue with backpressure.**  ``submit`` on a full
  queue returns a structured :class:`Backpressure` carrying an
  exponential-backoff ``retry_after`` (base × 2^retries, capped); the
  trace driver re-submits at that time.  Retries beyond ``max_retries``
  shed with reason ``"backpressure"``.  Nothing is silently dropped.
* **Priority draining under degradation.**  When the health verdict turns
  unhealthy the frontend admits at most ``degraded_admit`` requests per
  tick and drains its queue earliest-deadline-first until a replanned
  fleet is published and the next verdict is clean.
* **Zero-loss elastic recovery.**  Fault campaigns
  (:class:`ChaosCampaign`, built on :class:`~repro_torch.runtime.faults.
  FaultEvent`) inject kills / stragglers / dropped rounds into live runs.
  A mid-run worker kill interrupts the superstep runner at a barrier; the
  frontend stalls through the heartbeat-timeout outage (queued requests
  pay it in latency — and may shed on deadline — but are never lost),
  re-plans for the survivors through :class:`~repro_torch.runtime.elastic.
  ElasticPlanner`'s validated pipeline, migrates the barrier snapshot
  with :func:`~repro_torch.codegen.plan.migrate_registers` and resumes the
  in-flight batch on the m−1 fleet.  The **zero-loss invariant** —
  every submitted request either completes with output allclose to the
  fault-free reference or is shed with an explicit reason — is checked
  by :meth:`Frontend.audit` and CI-gated in ``benchmarks/serve_chaos.py``.

Everything runs on the :class:`~repro_torch.runtime.elastic.HealthMonitor`'s
simulated clock (the DAG's time unit), so an identical seed replays the
identical outcome — statuses, latencies, shed reasons and outputs.

Fault-free steady-state ticks can optionally run through the *compiled*
checkpointed segmented executor instead of the numpy superstep runner
(:meth:`Frontend.attach_executor`): executors are cached on the full knob
tuple — batch-size bucket plus ``(buffer_depth, span_coalesce,
cohort_rounds, bake_params)`` — so re-attaching with different knobs never
reuses a stale compile.  Rows are padded to the bucket, and every run
returns the packed segment-boundary snapshots (``.checkpoint_steps`` on
the executor) that recovery code migrates exactly like the runner's
barriers.

In the port, runs take place on the device the parameters live on: a
tick's rows cross from the ledger's numpy arrays to that device once, the
superstep runner (:func:`~repro_torch.runtime.faults.run_with_faults`)
issues each worker's supersteps on its own CUDA stream, and outputs come
back as numpy.  :meth:`Frontend.attach_executor` puts the m workers of the
segmented executor on m streams of one card (``device="cpu"`` runs them in
order on the CPU); its snapshots stay where the executor made them, in the
executor's one static snapshot tensor, which the next run overwrites.
Everything else is the reference's text.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.codegen.plan import (
    build_plan,
    coalesce_transfer_steps,
    migrate_registers,
    wcet_certificate,
)
from repro_torch.core.list_scheduling import dsh, ish
from repro_torch.runtime.elastic import ElasticPlanner, HealthMonitor
from repro_torch.runtime.faults import (
    FaultEvent,
    FaultPlan,
    RunOutcome,
    _plan_layout,
    _step_compute_times,
    resume_plan,
    run_with_faults,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve.trace import TraceRequest, trace_summary

__all__ = [
    "FrontendConfig",
    "ServeRequest",
    "Backpressure",
    "ChaosEvent",
    "ChaosCampaign",
    "Frontend",
]


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Admission/degradation policy knobs (times in service-estimate units
    unless stated; the simulated clock's unit is the DAG's)."""

    max_rows: int = 8            # batch rows per plan execution
    queue_limit: int = 32        # bounded admission queue (backpressure bar)
    max_retries: int = 3         # backoff attempts before a backpressure shed
    retry_base: float = 2.0      # retry_after = base * 2^retries (of est)
    retry_cap: float = 16.0      # backoff ceiling (of est)
    degraded_admit: int = 1      # requests admitted per tick while degraded
    deadline_margin: float = 1.0  # shed when now + margin*est > deadline
    heartbeat_timeout: float = 0.0  # sim units; 0 -> 3x service estimate
    straggler_factor: float = 2.0
    deadline_slack: float = 1.5  # WCET-overrun slack for the health verdict
    exclude_stragglers: bool = True  # replan detected stragglers out
    heuristic: str = "dsh"


@dataclasses.dataclass
class ServeRequest:
    """Ledger entry of one request: every submitted request lives here
    until it is ``done`` or ``shed`` — the zero-loss accounting unit."""

    rid: int
    rows: int
    pool_idx: int
    arrival: float
    deadline: float
    x: np.ndarray
    status: str = "queued"      # queued | backoff | running | done | shed
    admitted: Optional[float] = None
    finish: Optional[float] = None
    output: Optional[np.ndarray] = None
    shed_reason: Optional[str] = None
    retry_at: Optional[float] = None
    retries: int = 0

    @property
    def latency(self) -> Optional[float]:
        return None if self.finish is None else self.finish - self.arrival


@dataclasses.dataclass(frozen=True)
class Backpressure:
    """Structured admission rejection: retry after ``retry_after`` sim
    units (exponential backoff), or accept the shed at ``max_retries``."""

    reason: str
    retry_after: float


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One campaign trigger: once ``after_completed`` requests have
    finished, inject ``fault`` into the next run.  ``fault.worker`` is a
    *monitor* worker id (the frontend translates to the current plan's
    index); ``fault.step`` is the superstep within that run."""

    after_completed: int
    fault: FaultEvent


@dataclasses.dataclass(frozen=True)
class ChaosCampaign:
    """Replayable serving-level fault campaign — pure data from a seed."""

    events: Tuple[ChaosEvent, ...]
    seed: Optional[int] = None

    @staticmethod
    def kill_and_straggle(
        n_requests: int,
        n_workers: int,
        seed: int,
        straggle_factor: float = 4.0,
    ) -> "ChaosCampaign":
        """The headline drill: one worker killed around a third of the way
        through the trace, a *different* worker straggling around two
        thirds.  Deterministic function of its arguments."""
        rng = np.random.default_rng(seed)
        kill_w = int(rng.integers(n_workers))
        strag_w = int((kill_w + 1 + rng.integers(n_workers - 1)) % n_workers)
        kill_at = max(1, n_requests // 3)
        strag_at = max(kill_at + 1, (2 * n_requests) // 3)
        kill_step = int(rng.integers(1, 6))
        return ChaosCampaign(
            events=(
                ChaosEvent(kill_at, FaultEvent("kill", kill_step, kill_w)),
                ChaosEvent(
                    strag_at,
                    FaultEvent("straggle", 0, strag_w, straggle_factor),
                ),
            ),
            seed=seed,
        )


class Frontend:
    """Deadline/backpressure serving loop over a sliced execution plan.

    Built from the *sliced* model and its cost-annotated DAG, exactly like
    :func:`~repro_torch.runtime.faults.kill_and_resume_drill`: the plan is the
    validated ``build_plan`` → ``coalesce_transfer_steps`` output, runs
    execute through the superstep runner (or the compiled checkpointed
    executor, :meth:`attach_executor`), per-worker timings feed the
    :class:`HealthMonitor`, and degradation replans through
    :class:`ElasticPlanner`.
    """

    def __init__(
        self,
        model,
        params,
        dag,
        m: int,
        hw=None,
        cfg: FrontendConfig = FrontendConfig(),
        validate: bool = True,
        time_unit: float = 1e-6,
    ):
        self.model = model
        self.params = params
        self.dag = dag
        self.cfg = cfg
        self.hw = hw
        self.time_unit = time_unit
        heur = {"ish": ish, "dsh": dsh}[cfg.heuristic]
        self.plan = coalesce_transfer_steps(build_plan(heur(dag, m), dag))
        if validate:
            from repro_torch.codegen.validate import validate_plan

            # deep=True: the serving plan is proved race-free /
            # sync-sufficient / donation-safe before the first request
            validate_plan(self.plan, dag, model=model, deep=True)
        self.layout = _plan_layout(self.plan, model)
        self.worker_ids: List[int] = list(range(m))  # plan index -> monitor id
        self.cordoned: Set[int] = set()  # stragglers replanned out, still alive
        self.est_service = self._service_estimate(self.plan)
        self._ewma = self.est_service
        hb = cfg.heartbeat_timeout or 3.0 * self.est_service
        self.monitor = HealthMonitor(
            m, heartbeat_timeout=hb, straggler_factor=cfg.straggler_factor
        )
        self.planner = ElasticPlanner(
            dag, heuristic=cfg.heuristic, model=model, hw=hw,
            validate=validate, time_unit=time_unit,
        )
        self.certificate = None
        if hw is not None:
            out_bytes = {
                l.name: float(np.prod(l.out_shape)) * 4 for l in model.layers
            }
            self.certificate = wcet_certificate(
                self.plan, dag, out_bytes, hw=hw, time_unit=time_unit
            )
        self.degraded = False
        self.queue: List[ServeRequest] = []
        self.ledger: Dict[int, ServeRequest] = {}
        self.completed = 0
        self.retried = 0
        self.deadline_misses = 0
        self.recoveries: List[Dict[str, object]] = []
        self.runs = 0
        self.exec_runs = 0
        self.last_worker_times: List[Tuple[int, float]] = []
        self.last_snapshot = None  # (snaps ndarray, executor) from exec path
        self._chronic: Dict[int, float] = {}  # monitor id -> straggle factor
        self._fired: Set[int] = set()         # chaos events already injected
        self._step_times = _step_compute_times(self.plan, dag)
        self._devices = None
        self._buckets: Tuple[int, ...] = ()
        self._exec_knobs = (1, True, True, False)
        self._exec_cache: Dict[Tuple, object] = {}
        for w in range(m):
            self.monitor.heartbeat(w)

    # ------------------------------------------------------------------ #
    @property
    def now(self) -> float:
        return self.monitor.now

    @property
    def fleet(self) -> Tuple[int, ...]:
        """Monitor ids of the workers the current plan runs on."""
        return tuple(self.worker_ids)

    def _service_estimate(self, plan) -> float:
        times = _step_compute_times(plan, self.dag)
        return float(sum(max(ts) if ts else 0.0 for ts in times))

    def _est(self) -> float:
        """Live service estimate: static bound or observed EWMA, whichever
        is worse — a straggling fleet sheds deadlines earlier."""
        return max(self.est_service, self._ewma)

    # ---- admission ---------------------------------------------------- #
    def submit(
        self, req: TraceRequest, pool: np.ndarray
    ) -> Union[ServeRequest, Backpressure]:
        """Admit (or reject) one trace request.

        Returns the ledger entry on admission or terminal shed, or a
        :class:`Backpressure` telling the caller when to retry.  A request
        re-submitted after backoff reuses its ledger entry (``retries``
        accumulates across attempts)."""
        r = self.ledger.get(req.rid)
        if r is None:
            n_pool = len(pool)
            x = np.stack([
                pool[(req.pool_idx + j) % n_pool] for j in range(req.rows)
            ])
            r = ServeRequest(
                rid=req.rid, rows=req.rows, pool_idx=req.pool_idx,
                arrival=req.arrival, deadline=req.deadline, x=x,
            )
            self.ledger[req.rid] = r
        if r.rows > self.cfg.max_rows:
            self._shed(r, "too_large")
            return r
        now = self.now
        if now + self.cfg.deadline_margin * self._est() > r.deadline:
            self._shed(r, "deadline")
            return r
        if len(self.queue) >= self.cfg.queue_limit:
            if r.retries >= self.cfg.max_retries:
                self._shed(r, "backpressure")
                return r
            delay = min(
                self.cfg.retry_base * (2.0 ** r.retries), self.cfg.retry_cap
            ) * self.est_service
            r.retries += 1
            self.retried += 1
            r.status = "backoff"
            r.retry_at = now + delay
            return Backpressure("queue_full", delay)
        r.status = "queued"
        r.retry_at = None
        self.queue.append(r)
        return r

    def _shed(self, r: ServeRequest, reason: str) -> None:
        r.status = "shed"
        r.shed_reason = reason
        r.finish = self.now
        if r in self.queue:
            self.queue.remove(r)

    def _shed_expired(self) -> None:
        for r in list(self.queue):
            if self.now + self.cfg.deadline_margin * self._est() > r.deadline:
                self._shed(r, "deadline")

    def _admit(self) -> List[ServeRequest]:
        """Pack queued requests into one run.  Degraded mode drains
        earliest-deadline-first and admits at most ``degraded_admit``
        requests; healthy mode packs FIFO up to ``max_rows`` rows."""
        if not self.queue:
            return []
        if self.degraded:
            self.queue.sort(key=lambda r: (r.deadline, r.rid))
            limit = self.cfg.degraded_admit
        else:
            limit = None
        batch: List[ServeRequest] = []
        rows = 0
        rest: List[ServeRequest] = []
        for r in self.queue:
            full = (limit is not None and len(batch) >= limit) or (
                rows + r.rows > self.cfg.max_rows
            )
            if full:
                rest.append(r)
                continue
            r.status = "running"
            r.admitted = self.now
            batch.append(r)
            rows += r.rows
        self.queue = rest
        return batch

    # ---- health / degradation ----------------------------------------- #
    def _health_check(self) -> Dict[str, List[int]]:
        v = self.monitor.check(
            certificate=self.certificate, slack=self.cfg.deadline_slack
        )
        fleet = set(self.worker_ids)
        new_dead = [w for w in v["dead"] if w in fleet]
        new_strag = [w for w in v["stragglers"] if w in fleet]
        # WCET-attributed overruns count as stragglers for exclusion: on a
        # load-imbalanced sliced plan a chronically slow worker can sit far
        # below the cross-fleet median (light share x big slowdown) yet
        # blow its own certified per-step bounds — the certificate is the
        # per-worker baseline the median test lacks
        overruns = [w for w in v.get("deadline", ()) if w in fleet]
        slow = set(new_strag) | set(overruns)
        if new_dead:
            self._replan(exclude=slow if self.cfg.exclude_stragglers else ())
        elif slow and self.cfg.exclude_stragglers:
            self._replan(exclude=slow)
        # degraded until the replanned fleet is published *and* the next
        # verdict is clean — fleet membership is the ack: a worker
        # replanned out stops counting
        self.degraded = bool(new_dead or slow)
        return v

    def _replan(self, exclude: Sequence[int] = ()) -> Dict[str, object]:
        # a cordoned worker stays out of every later replan
        exclude = set(exclude) | self.cordoned
        t0 = time.perf_counter()
        eplan = self.planner.replan(
            self.monitor, exclude_stragglers=self.cfg.exclude_stragglers,
            certificate=self.certificate, slack=self.cfg.deadline_slack,
            exclude=exclude,
        )
        replan_ms = (time.perf_counter() - t0) * 1e3
        rec: Dict[str, object] = {
            "action": eplan.action,
            "at_sim": self.now,
            "at_completed": self.completed,
            "replan_ms": round(replan_ms, 2),
            "workers": tuple(eplan.workers),
        }
        if eplan.action == "continue" or eplan.plan is None:
            return rec
        alive = set(self.monitor.alive_workers())
        self.cordoned = alive - set(eplan.workers)
        self.plan = eplan.plan
        self.layout = _plan_layout(self.plan, self.model)
        self.certificate = eplan.certificate
        self.worker_ids = list(eplan.workers)
        self.est_service = self._service_estimate(self.plan)
        self._ewma = self.est_service
        self._step_times = _step_compute_times(self.plan, self.dag)
        self._exec_cache.clear()
        # the new plan is a new timing baseline: flush every live worker's
        # window so old-plan step indices/durations can't be judged against
        # the new certificate (spurious overruns would re-shrink the fleet)
        for w in self.monitor.workers.values():
            w.step_times.clear()
            w.timings.clear()
        rec["est_service"] = self.est_service
        self.recoveries.append(rec)
        return rec

    # ---- chaos -------------------------------------------------------- #
    def _active_faults(self, chaos: Optional[ChaosCampaign]) -> FaultPlan:
        events: List[FaultEvent] = []
        n_steps = len(self.plan.steps)
        idx_of = {mid: w for w, mid in enumerate(self.worker_ids)}
        if chaos is not None:
            for k, ev in enumerate(chaos.events):
                if k in self._fired or self.completed < ev.after_completed:
                    continue
                self._fired.add(k)
                f = ev.fault
                if f.kind == "straggle":
                    # chronic: the victim stays slow until replanned out
                    self._chronic[f.worker] = max(
                        self._chronic.get(f.worker, 1.0), f.factor
                    )
                    continue
                w = idx_of.get(f.worker)
                if w is None:
                    continue  # victim already out of the fleet: no-op
                step = min(max(f.step, 0), n_steps - 1)
                events.append(dataclasses.replace(f, step=step, worker=w))
        for mid, factor in self._chronic.items():
            w = idx_of.get(mid)
            if w is not None:
                events.append(FaultEvent("straggle", 0, w, factor))
        return FaultPlan(events=tuple(events), seed=chaos.seed if chaos else None)

    # ---- execution ---------------------------------------------------- #
    def _execute(self, x: np.ndarray, faults: FaultPlan) -> RunOutcome:
        if self._devices is not None and not faults.events:
            return self._exec_run(x)
        out = run_with_faults(
            self.plan, self.model, self.params, x, self.layout,
            faults=faults, monitor=self.monitor, dag=self.dag,
            worker_ids=self.worker_ids,
        )
        slow = {self.worker_ids[w]: f for w, f in out.straggled.items()}
        self.last_worker_times = [
            (mid, sum(
                ts[w] * slow.get(mid, 1.0) for ts in self._step_times
            ))
            for w, mid in enumerate(self.worker_ids)
        ]
        return out

    def _recover(self, outcome: RunOutcome, x: np.ndarray) -> RunOutcome:
        """Kill → detect → replan(m−1) → migrate → resume, mid-trace.

        The in-flight batch is *not* lost: its barrier snapshot migrates
        into the replanned layout and the survivors resume it.  The outage
        (heartbeat timeout until detection) advances the simulated clock,
        so queued requests pay it in latency — and may shed on deadline —
        which is the graceful half of graceful degradation."""
        kill = outcome.fault
        dead_mid = self.worker_ids[kill.worker]
        # the victim's heartbeat goes stale while survivors stall & beat
        self.monitor.advance(self.monitor.heartbeat_timeout + 1.0)
        for w in self.monitor.workers:
            st = self.monitor.workers[w]
            if st.alive and w != dead_mid:
                self.monitor.heartbeat(w)
        old_plan, old_layout = self.plan, self.layout
        rec = self._replan()
        assert rec["action"] != "continue" and self.plan is not old_plan, (
            "kill not reflected in the replanned fleet"
        )
        new_bufs, completed_nodes, mig = migrate_registers(
            old_plan, self.plan, old_layout, self.layout,
            outcome.snapshot, outcome.step,
        )
        resumed = resume_plan(
            self.plan, self.model, self.params, x, self.layout,
            new_bufs, completed_nodes, monitor=self.monitor, dag=self.dag,
            worker_ids=self.worker_ids,
        )
        assert resumed.status == "ok", "resumed run was interrupted again"
        rec.update(
            dead_worker=dead_mid,
            kill_step=outcome.step,
            outage_sim=self.monitor.heartbeat_timeout + 1.0,
            migrated_bytes=mig["migrated_bytes"],
            placements=mig["placements"],
            completed_nodes=mig["completed_nodes"],
        )
        self.degraded = True  # drain conservatively until the next clean check
        return resumed

    # ---- the serving tick --------------------------------------------- #
    def step(self, chaos: Optional[ChaosCampaign] = None) -> int:
        """One serving tick: health check, deadline shed, admit, execute
        (recovering in place if the run is killed), complete.  Returns the
        number of requests completed this tick."""
        self.runs += 1
        self._health_check()
        self._shed_expired()
        batch = self._admit()
        if not batch:
            return 0
        x = _params_device_tensor(
            np.concatenate([r.x for r in batch], axis=0), self.params
        )
        t_in = self.now
        outcome = self._execute(x, self._active_faults(chaos))
        if outcome.status == "killed":
            outcome = self._recover(outcome, x)
        for w in self.cordoned:
            self.monitor.heartbeat(w)
        y = np.asarray(outcome.output)
        now = self.now
        self._ewma = 0.7 * self._ewma + 0.3 * (now - t_in)
        off = 0
        for r in batch:
            r.output = y[off:off + r.rows]
            off += r.rows
            r.finish = now
            r.status = "done"
            self.completed += 1
            if now > r.deadline:
                self.deadline_misses += 1
        return len(batch)

    # ---- trace driver ------------------------------------------------- #
    def run_trace(
        self,
        trace: Sequence[TraceRequest],
        pool: np.ndarray,
        chaos: Optional[ChaosCampaign] = None,
        max_ticks: int = 1_000_000,
    ) -> Dict[str, object]:
        """Drive a full trace to drain: arrivals and backoff retries enter
        on the simulated clock, idle gaps fast-forward it, and every
        request ends ``done`` or ``shed``.  Returns the summary."""
        pending = sorted(trace, key=lambda t: (t.arrival, t.rid))
        pending.reverse()  # pop() from the tail = earliest first
        backoff: List[Tuple[float, int, TraceRequest]] = []
        t_wall = time.perf_counter()
        for _ in range(max_ticks):
            now = self.now
            while pending and pending[-1].arrival <= now:
                tr = pending.pop()
                res = self.submit(tr, pool)
                if isinstance(res, Backpressure):
                    heapq.heappush(backoff, (now + res.retry_after, tr.rid, tr))
            while backoff and backoff[0][0] <= now:
                _, _, tr = heapq.heappop(backoff)
                res = self.submit(tr, pool)
                if isinstance(res, Backpressure):
                    heapq.heappush(
                        backoff, (self.now + res.retry_after, tr.rid, tr)
                    )
            if self.queue:
                self.step(chaos)
                continue
            if not pending and not backoff:
                break
            # idle: fast-forward to the next arrival/retry, fleet beating
            nxt = min(
                ([pending[-1].arrival] if pending else [])
                + ([backoff[0][0]] if backoff else [])
            )
            self.monitor.advance(max(nxt - now, 1e-9))
            for w in list(self.worker_ids) + sorted(self.cordoned):
                self.monitor.heartbeat(w)
        else:
            raise RuntimeError("trace did not drain within max_ticks")
        return trace_summary(
            self.ledger.values(), time_unit=self.time_unit,
            wall_s=time.perf_counter() - t_wall,
        )

    # ---- zero-loss audit ---------------------------------------------- #
    def audit(
        self, ref_pool: Optional[np.ndarray] = None, atol: float = 1e-4
    ) -> Dict[str, object]:
        """The zero-loss ledger audit.

        Every submitted request must be terminal (``done`` or ``shed``),
        every shed must carry a reason, and — given ``ref_pool``, the
        fault-free per-pool-entry reference outputs — every completed
        output must be allclose to its reference.  ``zero_loss`` is the
        conjunction; the chaos benchmarks assert it."""
        leaked = [
            r.rid for r in self.ledger.values()
            if r.status not in ("done", "shed")
        ]
        unreasoned = [
            r.rid for r in self.ledger.values()
            if r.status == "shed" and not r.shed_reason
        ]
        max_err = 0.0
        diverged: List[int] = []
        if ref_pool is not None:
            n_pool = len(ref_pool)
            for r in self.ledger.values():
                if r.status != "done":
                    continue
                for j in range(r.rows):
                    ref = ref_pool[(r.pool_idx + j) % n_pool]
                    err = float(np.abs(r.output[j] - ref).max())
                    max_err = max(max_err, err)
                    if err > atol:
                        diverged.append(r.rid)
        done = sum(1 for r in self.ledger.values() if r.status == "done")
        shed = sum(1 for r in self.ledger.values() if r.status == "shed")
        return {
            "submitted": len(self.ledger),
            "completed": done,
            "shed": shed,
            "leaked": leaked,
            "unreasoned_sheds": unreasoned,
            "diverged": sorted(set(diverged)),
            "max_err": max_err,
            "zero_loss": not (leaked or unreasoned or diverged),
        }

    def fingerprint(self) -> Tuple:
        """Deterministic outcome digest for replay checks: per-request
        terminal status, shed reason, retry count, latency, and the exact
        output bytes."""
        out = []
        for rid in sorted(self.ledger):
            r = self.ledger[rid]
            digest = (
                None if r.output is None
                else hash(np.ascontiguousarray(r.output).tobytes())
            )
            out.append((
                rid, r.status, r.shed_reason, r.retries,
                None if r.latency is None else round(r.latency, 9), digest,
            ))
        return tuple(out)

    # ---- compiled-executor fast path ---------------------------------- #
    def attach_executor(
        self, device: DeviceLike = "cuda", buckets: Sequence[int] = (1, 2, 4, 8),
        buffer_depth: int = 1, span_coalesce: bool = True,
        cohort_rounds: bool = True, bake_params: bool = False,
    ) -> None:
        """Route fault-free ticks through the checkpointed segmented
        executor (``build_mpmd_executor(segmented=True, checkpoint=True)``)
        instead of the superstep runner: its m workers are m CUDA streams
        of one card (``device="cpu"``: in order, on the CPU).  Raises
        without CUDA unless ``device="cpu"``, and when the parameters live
        on another kind of device than ``device``.

        Executors are built lazily per batch-size bucket and cached under
        the **full knob tuple** ``(bucket, buffer_depth, span_coalesce,
        cohort_rounds, bake_params)`` — each with its CUDA graph, captured
        at its first run — so re-attaching with different knobs can never
        reuse a stale executor; the knobs go verbatim to
        ``build_mpmd_executor`` (outputs are bit-identical across them).  A
        replan clears the cache.  Each run stores ``(snaps, executor)`` on
        ``self.last_snapshot``: ``snaps`` is the executor's static snapshot
        tensor on its device, as the executor returns it (the reference
        stores a numpy copy; the values are the same packed carries the
        runner's barriers produce, ``executor.checkpoint_steps`` naming the
        superstep each is the entering barrier of).  Chaos runs (any
        injected fault) always take the runner path, which is the only
        interruptible one."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        p_dev = _params_device(self.params)
        if p_dev.type != dev.type:
            raise ValueError(
                f"the parameters live on {p_dev}; the executor would run on "
                f"{dev} (make them with device={dev.type!r})"
            )
        if max(buckets) < self.cfg.max_rows:
            raise ValueError(
                f"largest bucket {max(buckets)} < max_rows {self.cfg.max_rows}"
            )
        self._devices = dev  # the executor's device (the reference: a device list)
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        self._exec_knobs = (
            int(buffer_depth), bool(span_coalesce), bool(cohort_rounds),
            bool(bake_params),
        )
        self._exec_cache.clear()

    def _executor(self, rows: int):
        bucket = next(b for b in self._buckets if b >= rows)
        depth, span, cohort, bake = self._exec_knobs
        key = (bucket, depth, span, cohort, bake)
        f = self._exec_cache.get(key)
        if f is None:
            from repro_torch.codegen.executor import build_mpmd_executor

            f = build_mpmd_executor(
                self.plan, self.model, self.params, device=self._devices,
                batch=bucket, segmented=True, checkpoint=True,
                buffer_depth=depth, span_coalesce=span, cohort_rounds=cohort,
                bake_params=bake,
            )
            self._exec_cache[key] = f
        return f, bucket

    def _exec_run(self, x: torch.Tensor) -> RunOutcome:
        rows = int(x.shape[0])
        f, bucket = self._executor(rows)
        xp = x
        if bucket > rows:
            pad = x.new_zeros((bucket - rows, *x.shape[1:]))
            xp = torch.cat([x, pad], dim=0)
        y, snaps = f(xp)
        self.last_snapshot = (snaps, f)
        self.exec_runs += 1
        # clock/monitor parity with the runner: the executor gives no
        # per-worker wall times on a simulated fleet, so the plan's own
        # per-superstep compute times (chronic stragglers included) feed
        # the monitor exactly as the runner would
        slow = {
            w: self._chronic.get(mid, 1.0)
            for w, mid in enumerate(self.worker_ids)
        }
        for i, ts in enumerate(self._step_times):
            dts = [ts[w] * slow[w] for w in range(len(self.worker_ids))]
            for w, mid in enumerate(self.worker_ids):
                self.monitor.record_step(i, dts[w], worker=mid)
            self.monitor.advance(max(dts) if dts else 0.0)
        self.last_worker_times = [
            (mid, sum(ts[w] * slow[w] for ts in self._step_times))
            for w, mid in enumerate(self.worker_ids)
        ]
        return RunOutcome(
            status="ok", output=y[:rows].cpu().numpy(), snapshots={},
        )


def _params_device(params) -> torch.device:
    """The device the model's parameters live on (the CPU for a model
    without any)."""
    for leaves in params.values():
        for t in leaves.values():
            return t.device
    return torch.device("cpu")


def _params_device_tensor(x: np.ndarray, params) -> torch.Tensor:
    """A tick's rows on the parameters' device, where its run takes place."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(_params_device(params))
