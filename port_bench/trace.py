"""The device trace of a traced run, and what is read from it.

:class:`Trace` wraps ``torch.profiler`` (CPU and CUDA activity) around a part
of the measured window, marked by a ``port_bench.window`` span, and reduces
the raw events to: each device operation's interval and name, the union of
those intervals (the device's busy time), the idle gaps between them with
the host operation that was running at each gap's middle, and device time
by class of kernel (:func:`kernel_class`).
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

PORT_KERNEL = re.compile(r"\b(flash|swiglu|ssd)_\w*_kernel\b")
GEMM = re.compile(r"gemm|gemv|cutlass|xmma|nvjet|cublas|splitKreduce", re.I)
WINDOW = "port_bench.window"


def kernel_class(name: str) -> str:
    """``port`` (a kernel of the port's ``csrc/``), ``gemm`` (cuBLAS or
    CUTLASS products) or ``elementwise`` (everything else: elementwise
    passes, copies, reductions, memsets)."""
    if PORT_KERNEL.search(name):
        return "port"
    if GEMM.search(name):
        return "gemm"
    return "elementwise"


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """Profile from :meth:`start` to :meth:`stop` (which synchronises)."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def start_stop(self) -> None:
        """Start and stop once, reading nothing: the first start of a
        process initialises the device tracer, which takes seconds."""
        self.start()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof = None

    def stop(self) -> Dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        host_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        return reduce(events, host_s)


def reduce(events, host_s: float) -> Dict:
    """Busy seconds, window seconds, device seconds by kernel name and by
    class, and idle seconds by the host operation under each gap."""
    dev, host, win = [], [], None
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.name() == WINDOW:  # the span's host side; its device echo is no work
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                win = (a, b)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append((a, b, e.name()))
        else:
            host.append((a, b, e.name()))
    if win is None:
        win = (min(a for a, _, _ in dev + host), max(b for _, b, _ in dev + host))
    dev = [(max(a, win[0]), min(b, win[1]), n) for a, b, n in dev if b > win[0] and a < win[1]]
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    for a, b, n in dev:
        by_name[n] += (b - a) * 1e-9
        by_class[kernel_class(n)] += (b - a) * 1e-9
    busy = union([(a, b) for a, b, _ in dev])
    gaps, t = [], win[0]
    for a, b in busy + [(win[1], win[1])]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    host.sort()
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_host_at(host, (a + b) // 2)] += (b - a) * 1e-9
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9, "window_s": (win[1] - win[0]) * 1e-9,
            "host_window_s": host_s, "by_name": dict(by_name), "by_class": dict(by_class),
            "idle_by_host": dict(idle), "kernels": len(dev)}


def _host_at(host: List[Tuple[int, int, str]], t: int, look: int = 4096) -> str:
    """The innermost host operation running at t (the latest started, of the
    ``look`` started last, that has not ended), or ``python`` where none is."""
    i = bisect.bisect_right(host, (t, float("inf"), ""))
    for a, b, n in reversed(host[max(0, i - look):i]):
        if b >= t:
            return n
    return "python"


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
