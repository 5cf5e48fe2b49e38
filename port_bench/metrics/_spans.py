"""What the readers of the program's own spans and counters share.

Each reads ``repro_torch.runtime.spans.snapshot()`` in the run's process,
after its traffic ran.  Spans and counters record only while a profiler
runs, so the store holds the traced ticks or step alone.  A program without
the module, or a store with nothing of the kind, reads None.
"""
from __future__ import annotations


def snapshot():
    """The program's store, or None where the program has no spans."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.snapshot()


def per_tick_ms(*names):
    """Σ host ms of the spans named, over the number of ``engine.tick`` spans."""
    snap = snapshot()
    if not snap:
        return None
    ticks = sum(1 for s in snap["spans"] if s["name"] == "engine.tick")
    parts = [s["ms"] for s in snap["spans"] if s["name"] in names]
    return sum(parts) / ticks if ticks and parts else None


def per_step_device_ms(*names):
    """Σ device ms of the spans named (CUDA events on the stream), over the
    number of ``train.step`` spans; None where the spans carry no events."""
    snap = snapshot()
    if not snap:
        return None
    steps = sum(1 for s in snap["spans"] if s["name"] == "train.step")
    parts = [s["device_ms"] for s in snap["spans"] if s["name"] in names]
    if not steps or not parts or None in parts:
        return None
    return sum(parts) / steps


def moe_fill(*phases):
    """100 × Σ ``moe.kept`` over Σ ``moe.rows`` of the phases named: the
    share of the experts' rows that carry a token."""
    snap = snapshot()
    if not snap:
        return None
    c = snap["counters"]
    rows = sum(c.get(f"moe.rows.{p}", 0) for p in phases)
    kept = sum(c.get(f"moe.kept.{p}", 0) for p in phases)
    return 100.0 * kept / rows if rows else None
