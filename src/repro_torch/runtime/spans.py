"""Spans and counters inside the port: where a tick's or a step's time goes.

Off by default.  On while a torch profiler records, or between
:func:`enable` and :func:`disable` (the operator's switch).  Off, a span is
one flag check and a shared no-op context, and a counter one flag check: no
clock read, no allocation, no device op.

On, a span (``with span("engine.decode"): ...``) is

* a host event of its name in the profiler's own trace, so it shares the
  device kernels' clock.  It is an op-level annotation
  (``_RecordFunctionFast``), not ``record_function``: the profiler echoes a
  user annotation as a device event covering the kernels under it, which a
  reader of the device timeline would count as device work;
* a record in this module's store: name, id, the id of the span that
  enclosed it on its thread (``parent``, 0 at the top; autograd's thread
  keeps a stack of its own), request id ``rid`` and size ``n`` where the
  caller gives them, the thread, and host start and end
  (``time.perf_counter_ns``).  ``span(..., device=True)`` also records a
  timing CUDA event at each edge on the current stream, read back by
  :func:`snapshot` as ``device_ms``.

Counters add up only while on: :func:`count` host integers, and
:func:`count_device` 0-d tensors into a device accumulator, with no sync.
:func:`snapshot` reads the store (it synchronises once, for the device
counters and events) together with the kernel libraries' launch counts
(``KernelLibrary.counts``); :func:`clear` empties the store.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["enable", "disable", "active", "span", "mark", "count", "count_device",
           "snapshot", "clear"]

_switch = False
_spans: List["_Span"] = []
_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # counters may be added to from autograd's thread too


def enable() -> None:
    """Record spans and counters until :func:`disable`, profiler or not."""
    global _switch
    _switch = True


def disable() -> None:
    global _switch
    _switch = False


def active() -> bool:
    """Whether spans and counters record: the switch is on or a profiler records."""
    return _switch or _profiler._is_profiler_enabled


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _stack() -> List[int]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Span:
    __slots__ = ("name", "rid", "n", "id", "parent", "thread", "t0", "t1", "events", "_rf")

    def __init__(self, name: str, rid: Optional[int], n: Optional[int], device: bool):
        self.name, self.rid, self.n = name, rid, n
        self.events = [] if device and torch.cuda.is_initialized() else None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else 0
        self.id = next(_ids)
        stack.append(self.id)
        self.thread = threading.get_ident()
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events.append(torch.cuda.Event(enable_timing=True))
            self.events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        _stack().pop()
        _spans.append(self)
        return False


def span(name: str, rid: Optional[int] = None, n: Optional[int] = None, device: bool = False):
    """A context that records the time spent in it (see the module's text)."""
    if not (_switch or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, rid, n, device)


def mark(name: str, start_ns: int, rid: Optional[int] = None) -> None:
    """A span that began at ``start_ns`` (``perf_counter_ns``) and ends now,
    kept in the store only: the profiler takes no event after the fact."""
    if not (_switch or _profiler._is_profiler_enabled):
        return
    s = _Span(name, rid, None, False)
    s.id, s.parent, s.thread = next(_ids), 0, threading.get_ident()
    s.t0, s.t1 = start_ns, time.perf_counter_ns()
    _spans.append(s)


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    if _switch or _profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the 0-d integer tensor ``t`` to counter ``name`` on its device, with no sync."""
    if _switch or _profiler._is_profiler_enabled:
        with _lock:
            acc = _device_counts.get(name)
            if acc is None:
                _device_counts[name] = t.detach().to(torch.int64, copy=True)
            else:
                acc.add_(t.detach())


def snapshot() -> Dict[str, Any]:
    """``{"spans": [...], "counters": {...}, "launches": {...}}``: every
    span recorded since the last :func:`clear` in order of start (each a
    dict of ``name``, ``id``, ``parent``, ``rid``, ``n``, ``thread``,
    ``start_ns``, ``end_ns``, ``ms`` and ``device_ms``, None without
    events), every counter, host and device, and each kernel library's
    launch counts by variant."""
    from repro_torch.kernels import LIBRARIES

    done = list(_spans)
    if any(t.is_cuda for t in _device_counts.values()) or any(s.events for s in done):
        torch.cuda.synchronize()
    out = []
    for s in sorted(done, key=lambda s: s.t0):
        out.append({"name": s.name, "id": s.id, "parent": s.parent, "rid": s.rid, "n": s.n,
                    "thread": s.thread, "start_ns": s.t0, "end_ns": s.t1,
                    "ms": (s.t1 - s.t0) * 1e-6,
                    "device_ms": s.events[0].elapsed_time(s.events[1]) if s.events else None})
    counters = dict(_counts)
    counters.update({k: int(v) for k, v in _device_counts.items() if not v.is_meta})
    return {"spans": out, "counters": counters,
            "launches": {lib.name: dict(lib.counts) for lib in LIBRARIES}}


def clear() -> None:
    """Empty the store (spans and counters); the launch counts are the libraries'."""
    _spans.clear()
    _counts.clear()
    _device_counts.clear()
