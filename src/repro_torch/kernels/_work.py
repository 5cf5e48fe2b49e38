"""What a region of work does: the FLOPs of its aten ops, the work of each
kernel call, and the peak of the memory it allocates.

Each public entry of the kernel modules (``flash_attention``,
``swiglu_matmul``, ``swiglu_experts``, ``ssd_scan``, ``ssd_mixer``,
``causal_conv``) calls
:func:`record` once a call, with the variant that a CUDA call of those
shapes and dtype launches (its module's ``select_variant``) and that
call's operations and bytes (its module's ``work``).  So a call counts the
same work whichever implementation then runs: the CUDA kernel, the
shape-only path on ``meta`` tensors, or the plain version on the CPU.

A :class:`WorkLog` counts the region it is open over:

- ``aten``: FLOPs of the aten ops (``torch.utils.flop_counter``'s
  registry: matrix products, convolutions, attention), by op;
- ``calls[(kernel, variant)] = [calls, operations, bytes]``: the records
  of the kernel calls, backward kernels (``*_bwd``) included; the PyTorch
  part of a kernel's backward (an explicit VJP, or the products around a
  backward kernel) runs under :func:`uncounted` with ``component=kernel``
  and is recorded as ``(kernel, "vjp")`` with its aten FLOPs (and no byte
  count);
- ``peak``: the most bytes held at once by the storages created in the
  region (outputs of ops that alias no input), the operands it was given
  not included;
- ``unbatched``: the FLOPs of the products with no batch dim among the aten
  ops (``mm``, ``addmm``, and ``bmm`` over a batch of one, as ``einsum``
  lowers a projection) and the dense SwiGLU kernel's forward: the products
  whose outputs the reference's remat policy (``dots_with_no_batch_dims``)
  saves rather than recomputes.

The plain versions run under :func:`uncounted` too: their aten ops are the
call's recorded work and are not counted a second time.  Nothing is
recorded, and nothing suspended, while no log is open.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["WorkLog", "record", "uncounted"]

_OPEN: List["WorkLog"] = []
_LOCK = threading.Lock()


_UNBATCHED = {"aten::mm", "aten::addmm"}


class _Live(TorchDispatchMode):
    """Tracks the bytes of the storages that the ops it sees create, while
    they live (a finaliser on each storage), and their peak; sums the FLOPs
    of the products with no batch dim."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.unbatched = 0.0
        self.entries: Dict[int, list] = {}  # id(storage) -> [owner, bytes, weakref]

    @staticmethod
    def _release(key: int, entry) -> None:
        with _LOCK:
            owner = entry[0]
            owner.live -= entry[1]
            if owner.entries.get(key) is entry:
                del owner.entries[key]

    def track(self, storage, nbytes: int) -> None:
        entry = [self, nbytes, weakref.ref(storage)]
        with _LOCK:
            self.entries[id(storage)] = entry
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(storage, _Live._release, id(storage), entry)

    def adopt(self, inner: "_Live") -> None:
        """Take over the storages ``inner`` created that are still alive,
        and fold its peak in on top of what this one held meanwhile."""
        with _LOCK:
            self.peak = max(self.peak, self.live + inner.peak)
            for key, entry in list(inner.entries.items()):
                if entry[2]() is not None:
                    entry[0] = self
                    inner.live -= entry[1]
                    self.live += entry[1]
                    self.entries[key] = entry
            inner.entries.clear()
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name in _UNBATCHED or (name == "aten::bmm" and args[0].shape[0] == 1):
            a, b = args[-2], args[-1]
            self.unbatched += 2.0 * a.shape[-2] * a.shape[-1] * b.shape[-1]
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for ret, t in zip(returns, outs):
            if ret.alias_info is None and isinstance(t, torch.Tensor):
                s = t.untyped_storage()
                if id(s) not in self.entries or self.entries[id(s)][2]() is not s:
                    self.track(s, s.nbytes())
        return out


class WorkLog:
    """Counts the region inside ``with WorkLog() as log:`` (module
    docstring)."""

    def __init__(self, _nested: bool = False):
        self.calls: Dict[Tuple[str, str], List[float]] = {}
        self.aten: Dict[str, float] = {}
        self.peak = 0
        self.unbatched = 0.0
        self._nested = _nested
        self._stack: Optional[contextlib.ExitStack] = None

    def __enter__(self) -> "WorkLog":
        self._stack = contextlib.ExitStack()
        self._flops = self._stack.enter_context(FlopCounterMode(display=False))
        self._live = self._stack.enter_context(_Live())
        if not self._nested:
            _OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self._stack.close()
        if not self._nested:
            _OPEN.remove(self)
        counts = self._flops.get_flop_counts().get("Global", {})
        self.aten = {str(op): float(n) for op, n in counts.items()}
        self.peak = self._live.peak
        self.unbatched += self._live.unbatched

    def add(self, kernel: str, variant: str, flops: float, nbytes: float) -> None:
        if kernel == "swiglu_matmul" and not variant.startswith(("experts", "vjp")) and \
                not variant.endswith("_bwd"):
            self.unbatched += flops
        row = self.calls.setdefault((kernel, variant), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes


def record(kernel: str, variant: str, work: Tuple[float, float]) -> None:
    """One call of ``kernel`` through ``variant`` doing ``work`` =
    (operations, bytes), into every open log."""
    for log in _OPEN:
        log.add(kernel, variant, *work)


@contextlib.contextmanager
def uncounted(component: Optional[str] = None) -> Iterator[None]:
    """Run the body with the open logs' dispatch modes suspended, in a
    nested count of its own: its allocations fold into the innermost open
    log's peak, and with ``component`` its aten FLOPs are recorded as
    ``(component, "vjp")`` (otherwise they are dropped: the body is a plain
    version, whose work its entry recorded)."""
    if not _OPEN:
        yield
        return
    outer = _OPEN[-1]
    with _disable_current_modes():
        inner = WorkLog(_nested=True)
        with inner:
            yield
    outer._live.adopt(inner._live)
    if component is not None:
        for log in _OPEN:
            log.add(component, "vjp", sum(inner.aten.values()), 0.0)
