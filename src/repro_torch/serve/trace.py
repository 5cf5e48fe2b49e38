"""Seeded synthetic request traces for the serving frontend.

A trace is pure data: Poisson arrivals with mixed request sizes, each
request carrying an absolute deadline and an index into a small shared
input pool.  Every field is a deterministic function of the seed, so a
chaos drill that replays the same trace (and the same
:class:`~repro_torch.serve.frontend.ChaosCampaign`) must reproduce the identical
outcome — the replay contract the zero-loss CI gate asserts.

Times are in the executed plan's own *simulated* time unit (the DAG's
``t`` annotations, the clock :class:`~repro_torch.runtime.elastic.HealthMonitor`
advances on).  Wall-clock never enters the trace, which is what makes the
drill deterministic; :func:`trace_summary` converts to milliseconds for
reporting via the ``time_unit`` the DAG was priced with.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TraceRequest",
    "poisson_trace",
    "input_pool",
    "percentile",
    "trace_summary",
]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival of a synthetic serving trace.

    ``rows`` is the request's batch-row count (the mixed-size axis);
    ``pool_idx`` selects its input rows from the shared pool (row ``j``
    reads pool entry ``(pool_idx + j) % pool_size``, so references are
    computable per pool entry instead of per request).  ``deadline`` is
    absolute simulated time.
    """

    rid: int
    arrival: float
    rows: int
    pool_idx: int
    deadline: float


def poisson_trace(
    n: int,
    seed: int,
    rate: float,
    rows: Sequence[int] = (1, 2),
    pool_size: int = 8,
    deadline: Tuple[float, float] = (8.0, 24.0),
    service: float = 1.0,
) -> Tuple[TraceRequest, ...]:
    """Seeded Poisson trace: ``n`` arrivals at mean ``rate`` requests per
    simulated time unit, row counts drawn uniformly from ``rows``, and a
    per-request deadline of ``arrival + U(*deadline) * service`` (pass the
    frontend's service estimate so deadlines scale with the plan).

    Deterministic function of its arguments — same seed, same trace.
    """
    if n <= 0 or rate <= 0:
        raise ValueError(f"need n > 0 and rate > 0 (got n={n}, rate={rate})")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        r = int(rows[int(rng.integers(len(rows)))])
        p = int(rng.integers(pool_size))
        dl = t + float(rng.uniform(*deadline)) * service
        out.append(TraceRequest(rid, t, r, p, dl))
    return tuple(out)


def input_pool(shape: Sequence[int], pool_size: int, seed: int) -> np.ndarray:
    """Shared seeded input pool of ``pool_size`` samples of ``shape``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((pool_size, *shape)).astype(np.float32)


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(np.ceil(q / 100.0 * len(s))) - 1))
    return float(s[k])


def trace_summary(
    requests: Iterable["object"],
    time_unit: float = 1e-6,
    wall_s: Optional[float] = None,
) -> Dict[str, object]:
    """Latency/throughput/accounting summary of a completed trace.

    ``requests`` are the frontend's ledger entries (anything with
    ``status`` / ``arrival`` / ``finish`` / ``deadline`` / ``shed_reason``
    / ``retries``).  Latencies are reported in milliseconds via
    ``time_unit`` (seconds per simulated unit); ``requests_per_s`` is
    simulated throughput over the span from first arrival to last finish.
    """
    reqs = list(requests)
    done = [r for r in reqs if r.status == "done"]
    shed = [r for r in reqs if r.status == "shed"]
    lat = [r.finish - r.arrival for r in done]
    to_ms = time_unit * 1e3
    shed_by: Dict[str, int] = {}
    for r in shed:
        shed_by[r.shed_reason or "?"] = shed_by.get(r.shed_reason or "?", 0) + 1
    span = 0.0
    if done:
        span = max(r.finish for r in done) - min(r.arrival for r in reqs)
    out: Dict[str, object] = {
        "n_requests": len(reqs),
        "completed": len(done),
        "shed": len(shed),
        "shed_by_reason": shed_by,
        "retried": sum(r.retries for r in reqs),
        "deadline_misses": sum(1 for r in done if r.finish > r.deadline),
        "p50_ms": round(percentile(lat, 50) * to_ms, 4) if lat else None,
        "p99_ms": round(percentile(lat, 99) * to_ms, 4) if lat else None,
        "requests_per_s": (
            round(len(done) / (span * time_unit), 2) if span > 0 else None
        ),
    }
    if wall_s is not None:
        out["wall_s"] = round(wall_s, 2)
    return out
