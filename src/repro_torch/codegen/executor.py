"""Plan execution: a Python interpreter (the logic oracle) and the MPMD
executor, m workers as m CUDA streams on one card.

Port of the unrolled half of ``repro/codegen/executor.py``.  The reference
lowers a plan to one ``shard_map`` over a mesh axis of m devices: each
superstep runs every worker's compute segment as a branch of a
``lax.switch`` and then its comm round as ``lax.ppermute`` collectives.
Here the m workers are m ``torch.cuda.Stream``\\ s of one card, each owning
a register dict of its own tensors:

* **supersteps** — each worker's compute segment is issued on its own
  stream (cuDNN convolutions, cuBLAS products), then the comm round;
* **transfers** — ACETONE's Writing/Reading protocol: the source stream
  packs what it sends into a fresh payload (Writing), records an event
  (the flag), and the destination stream waits on that event and copies
  the payload into its own registers (Reading).  A destination never holds
  an alias of a source tensor, and no stream reads a register of another.
  A windowed transfer writes only its box into a register that was born
  zero, so a box-inference bug shows numerically, as in the reference;
* **fused or per-node comm** — ``fuse_transfers=True`` ships one flat
  payload per ``(src, dst)`` pair of each permutation round, padded to the
  round's largest pair as ``ppermute`` pads it, and unpacks it on arrival;
  ``fuse_transfers=False`` ships one payload per ``(node, box)`` group.
  Either way the bytes the destinations copy equal
  :func:`executed_comm_bytes`;
* **liveness** — registers are dropped on every worker after the reference's
  death superstep (:func:`plan_liveness`); a register is materialized on a
  worker when that worker first writes it;
* **capture** — on the card the executor captures the whole static plan,
  at its first call, into one CUDA graph spanning the m streams and replays
  it after that: the counterpart of ``jax.jit`` over the unrolled loop.
  ``.eager(x)`` runs the same program uncaptured.

On the CPU (``device="cpu"``) the same program runs eagerly, in order, with
no streams.  The segmented executor (``segmented=True`` in the reference)
comes with a later slice.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.codegen.plan import (
    ExecutionPlan,
    Transfer,
    _permutation_rounds,
    coalesce_transfer_steps,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.cnn import CNNModel, Params, apply_layer

__all__ = [
    "interpret_plan",
    "build_mpmd_executor",
    "plan_liveness",
    "executed_comm_bytes",
    "MPMDExecutor",
]


def _box_index(t: Transfer) -> Tuple[slice, ...]:
    """Batched register index of a windowed transfer's payload.

    One slice per per-sample axis, so 2-D grid-tile hulls (a row window ×
    a channel window) ship exactly like single-axis windows."""
    return (slice(None), *(slice(lo, hi) for (lo, hi) in t.box))


# --------------------------------------------------------------------------- #
# register liveness
# --------------------------------------------------------------------------- #
def plan_liveness(
    plan: ExecutionPlan, model: CNNModel
) -> Tuple[Dict[str, int], Dict[str, int], List[Set[str]]]:
    """Static birth/death supersteps of every register in ``plan``.

    ``birth[b]`` is the first superstep where ``b`` is computed on any
    worker; ``death[b]`` the last superstep where ``b`` is read — as a
    compute input, as a transfer payload, or (for the sink) at plan exit
    (``death[sink] == len(plan.steps)``, i.e. past every step).  Returns
    ``(birth, death, live_sets)`` where ``live_sets[i]`` is the set of
    buffers the executor must hold during superstep ``i``.
    """
    n = len(plan.steps)
    birth: Dict[str, int] = {}
    death: Dict[str, int] = {}
    for i, step in enumerate(plan.steps):
        for seg in step.compute:
            for name in seg:
                birth.setdefault(name, i)
                death[name] = max(death.get(name, i), i)
                spec = model.spec(name)
                if spec.op != "input":
                    for p in spec.inputs:
                        death[p] = max(death.get(p, i), i)
        for t in step.transfers:
            # a transfer both reads the register and materializes it on the
            # destination: a node whose first appearance is as a transfer
            # payload (e.g. a transfer-only first round in a hand-built
            # plan) must be born at its producing superstep, not default to
            # an unborn buffer with death at step 0
            birth.setdefault(t.node, i)
            death[t.node] = max(death.get(t.node, birth[t.node]), i)
    death[plan.sink] = n  # the output buffer survives the whole plan
    live_sets = [
        {b for b, bi in birth.items() if bi <= i <= death[b]} for i in range(n)
    ]
    return birth, death, live_sets


# --------------------------------------------------------------------------- #
# python interpreter — the oracle for plan logic (no streams)
# --------------------------------------------------------------------------- #
def interpret_plan(
    plan: ExecutionPlan,
    model: CNNModel,
    params: Params,
    x: torch.Tensor,
) -> torch.Tensor:
    """Execute the plan with per-worker register dicts in Python, in order,
    on the device of ``x``.

    Used by tests to check plan logic (availability, supplier choice,
    transfer completeness) independent of the streams and events of the
    MPMD executor.  Registers are never written in place.
    """
    regs: List[Dict[str, torch.Tensor]] = [dict() for _ in range(plan.n_workers)]
    for step in plan.steps:
        for w, seg in enumerate(step.compute):
            for name in seg:
                spec = model.spec(name)
                ins = [x] if spec.op == "input" else [regs[w][p] for p in spec.inputs]
                regs[w][name] = apply_layer(spec, params, ins)
        for t in step.transfers:
            src = regs[t.src][t.node]
            if t.box is None:
                regs[t.dst][t.node] = src
            else:
                # windowed transfer: copy only the consumed hull, leaving
                # the rest of the destination register unmaterialized
                # (zeros) — consumers read strictly inside the hull, and
                # this oracle catches any box-inference bug numerically
                idx = _box_index(t)
                cur = regs[t.dst].get(t.node)
                cur = torch.zeros_like(src) if cur is None else cur.clone()
                cur[idx] = src[idx]
                regs[t.dst][t.node] = cur
    return regs[plan.sink_worker][plan.sink]


# --------------------------------------------------------------------------- #
# MPMD executor: one CUDA stream per worker
# --------------------------------------------------------------------------- #
class _Workers:
    """Where worker ``w``'s work is issued: its own CUDA stream on the card;
    on the CPU, the calling thread, in program order (no streams)."""

    def __init__(self, m: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.streams: List[torch.cuda.Stream] = (
            [torch.cuda.Stream(device) for _ in range(m)] if self.cuda else []
        )

    def on(self, w: int):
        return torch.cuda.stream(self.streams[w]) if self.cuda else contextlib.nullcontext()

    def flag(self, w: int) -> Optional[torch.cuda.Event]:
        """Record worker ``w``'s Writing flag: everything issued on its
        stream so far (its compute, its packed payloads) is done."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self.streams[w])
        return ev

    def wait(self, w: int, flag: Optional[torch.cuda.Event]) -> None:
        if self.cuda:
            self.streams[w].wait_event(flag)

    def hand_over(self, t: torch.Tensor, w: int) -> None:
        """``t`` was made on another stream and is read on ``w``'s: the
        caching allocator must not reuse its memory before ``w`` is done."""
        if self.cuda:
            t.record_stream(self.streams[w])


# one payload to pack on a source: (key, [(transfer, offset)], length);
# one delivery to a destination: (src, key, [(transfer, offset)], length)
_Send = Tuple[Tuple, List[Tuple[Transfer, int]], int]
_Recv = Tuple[int, Tuple, List[Tuple[Transfer, int]], int]


class MPMDExecutor:
    """``f(x) -> y``: the plan on m workers (see the module docstring).

    Built by :func:`build_mpmd_executor`.  On the card, ``f(x)`` replays one
    CUDA graph of the whole plan, captured at the first call; ``f.eager(x)``
    issues the same program on the m streams without capture.  After each
    issue (eager, or the capture), ``comm_bytes`` holds the bytes the
    destinations copied and ``streams_used`` the streams that received work.
    """

    def __init__(self, plan: ExecutionPlan, model: CNNModel, params: Params,
                 device: torch.device, batch: int, liveness: bool, fuse_transfers: bool):
        self.plan, self.model, self.params = plan, model, params
        self.device, self.batch = device, batch
        self.fuse_transfers = fuse_transfers
        self._workers = _Workers(plan.n_workers, device)
        self.streams = self._workers.streams
        self.reg_shapes = {l.name: (batch, *l.out_shape) for l in model.layers}
        self.in_shape = self.reg_shapes[model.layers[0].name]
        n_steps = len(plan.steps)
        self.dead_after: List[List[str]] = [[] for _ in range(n_steps)]
        if liveness:
            _birth, death, _live = plan_liveness(plan, model)
            for b, d in death.items():
                if d < n_steps:
                    self.dead_after[d].append(b)
        comm = self._fused_comm if fuse_transfers else self._per_node_comm
        self._sends: List[Dict[int, List[_Send]]] = []
        self._recvs: List[Dict[int, List[_Recv]]] = []
        for step in plan.steps:
            sends, recvs = comm(step.transfers)
            self._sends.append(sends)
            self._recvs.append(recvs)
        self.comm_bytes = 0
        self.streams_used: Set[int] = set()
        self._graph = None
        self._static_x = self._static_y = None

    # -- static comm lowering ------------------------------------------------ #
    def _t_size(self, t: Transfer) -> int:
        """Flattened payload elements of one transfer (incl. batch dim)."""
        shape = self.reg_shapes[t.node] if t.box is None else (
            self.batch, *(hi - lo for (lo, hi) in t.box))
        return int(np.prod(shape))

    def _fused_comm(self, transfers):
        """One flat payload per ``(src, dst)`` pair of each permutation
        round, padded to the round's largest pair (as ``ppermute`` ships
        it); windowed transfers contribute only their consumed hull."""
        pair_ts: Dict[Tuple[int, int], List[Transfer]] = {}
        for t in transfers:
            pair_ts.setdefault((t.src, t.dst), []).append(t)
        sends: Dict[int, List[_Send]] = {}
        recvs: Dict[int, List[_Recv]] = {}
        for r, round_pairs in enumerate(_permutation_rounds(sorted(pair_ts))):
            length = max(sum(self._t_size(t) for t in pair_ts[p]) for p in round_pairs)
            for (s, d) in round_pairs:
                parts, off = [], 0
                for t in pair_ts[(s, d)]:
                    parts.append((t, off))
                    off += self._t_size(t)
                key = ("round", r)  # the sources of a round are distinct
                sends.setdefault(s, []).append((key, parts, length))
                recvs.setdefault(d, []).append((s, key, parts, length))
        return sends, recvs

    def _per_node_comm(self, transfers):
        """One payload per communicated ``(node, box)`` group: its source
        packs it once, and each destination copies it into its register
        (a multicast is one payload read by several destinations)."""
        by_key: Dict[Tuple[str, Optional[Tuple]], List[Transfer]] = {}
        for t in transfers:
            by_key.setdefault((t.node, t.box), []).append(t)
        sends: Dict[int, List[_Send]] = {}
        recvs: Dict[int, List[_Recv]] = {}
        for (node, box), ts in sorted(by_key.items(), key=lambda kv: (kv[0][0], kv[0][1] or ())):
            size = self._t_size(ts[0])
            packed: Set[int] = set()
            for perm in _permutation_rounds([(t.src, t.dst) for t in ts]):
                for (s, d) in perm:
                    t = next(t for t in ts if (t.src, t.dst) == (s, d))
                    key = ("node", node, box)
                    if s not in packed:
                        packed.add(s)
                        sends.setdefault(s, []).append((key, [(t, 0)], size))
                    recvs.setdefault(d, []).append((s, key, [(t, 0)], size))
        return sends, recvs

    # -- one issue of the program -------------------------------------------- #
    def _view(self, t: Transfer, flat: torch.Tensor, off: int) -> torch.Tensor:
        shape = self.reg_shapes[t.node] if t.box is None else (
            self.batch, *(hi - lo for (lo, hi) in t.box))
        return flat[off:off + self._t_size(t)].view(shape)

    def _pack(self, regs: Dict[str, torch.Tensor], parts, length: int) -> torch.Tensor:
        """Writing: a fresh flat payload holding the parts, zero-padded."""
        payload = torch.empty(length, dtype=torch.float32, device=self.device)
        end = 0
        for t, off in parts:
            src = regs[t.node] if t.box is None else regs[t.node][_box_index(t)]
            self._view(t, payload, off).copy_(src)
            end = off + self._t_size(t)
        if end < length:
            payload[end:].zero_()
        return payload

    def _deliver(self, regs: Dict[str, torch.Tensor], payload: torch.Tensor, parts,
                 length: int) -> int:
        """Reading: copy a payload into this worker's registers; returns the
        bytes copied out of the payload."""
        if self.fuse_transfers:
            recv = torch.empty(length, dtype=torch.float32, device=self.device)
            recv.copy_(payload)  # the pair's whole padded payload, as shipped
            for t, off in parts:
                chunk = self._view(t, recv, off)
                if t.box is None:
                    regs[t.node] = chunk
                else:
                    self._write_box(regs, t, chunk)
            return recv.numel() * recv.element_size()
        (t, off), = parts
        chunk = self._view(t, payload, off)
        if t.box is None:
            regs[t.node] = chunk.clone()
        else:
            self._write_box(regs, t, chunk)
        return chunk.numel() * chunk.element_size()

    def _write_box(self, regs: Dict[str, torch.Tensor], t: Transfer, chunk: torch.Tensor) -> None:
        reg = regs.get(t.node)
        if reg is None:  # born zero: only the box is ever written
            reg = torch.zeros(self.reg_shapes[t.node], dtype=torch.float32, device=self.device)
            regs[t.node] = reg
        reg[_box_index(t)].copy_(chunk)

    def _issue(self, x: torch.Tensor) -> torch.Tensor:
        """Issue the whole plan once: compute segments on the workers'
        streams, comm rounds ordered by events, the sink worker's output.
        On the card the calling stream waits on every worker at the end."""
        plan, W = self.plan, self._workers
        m = plan.n_workers
        regs: List[Dict[str, torch.Tensor]] = [dict() for _ in range(m)]
        copied, used = 0, set()
        caller = torch.cuda.current_stream(self.device) if W.cuda else None
        if W.cuda:
            for s in W.streams:
                s.wait_stream(caller)
        for i, step in enumerate(plan.steps):
            outbox: Dict[Tuple[int, Tuple], torch.Tensor] = {}
            flags = {}
            for w in range(m):
                seg, sends = step.compute[w], self._sends[i].get(w, ())
                if not seg and not sends:
                    continue
                used.add(w)
                with W.on(w):
                    for name in seg:
                        spec = self.model.spec(name)
                        ins = [x] if spec.op == "input" else [regs[w][p] for p in spec.inputs]
                        regs[w][name] = apply_layer(spec, self.params, ins).to(torch.float32)
                    for key, parts, length in sends:
                        outbox[(w, key)] = self._pack(regs[w], parts, length)
                    if sends:
                        flags[w] = W.flag(w)
            for d, recvs in self._recvs[i].items():
                used.add(d)
                with W.on(d):
                    for s in sorted({s for (s, *_rest) in recvs}):
                        W.wait(d, flags[s])
                    for (s, key, parts, length) in recvs:
                        payload = outbox[(s, key)]
                        W.hand_over(payload, d)
                        copied += self._deliver(regs[d], payload, parts, length)
            for b in self.dead_after[i]:
                for r in regs:
                    r.pop(b, None)
        out = regs[plan.sink_worker][plan.sink]
        if W.cuda:
            for s in W.streams:
                caller.wait_stream(s)
            out.record_stream(caller)
        self.comm_bytes = copied
        self.streams_used = ({W.streams[w].cuda_stream for w in used} if W.cuda else set())
        return out

    # -- entry points ------------------------------------------------------ #
    def _check(self, x: torch.Tensor) -> None:
        _check_batch(x, self.batch)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(f"input shape {tuple(x.shape)} != {self.in_shape}")
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, executor built for {self.device}")

    def eager(self, x: torch.Tensor) -> torch.Tensor:
        """The program issued op by op on the workers' streams, uncaptured."""
        self._check(x)
        return self._issue(x)

    def _capture(self, x: torch.Tensor) -> None:
        """Capture the plan into one CUDA graph over the m streams, with a
        static copy of ``x`` as its input.  One eager issue on the same
        streams runs first, so that the libraries' per-stream handles and
        workspaces exist before capture.  Raises if capture fails."""
        self._static_x = x.clone()
        self._issue(self._static_x)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_y = self._issue(self._static_x)
        self._graph = graph

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        if not self._workers.cuda:
            return self._issue(x)
        if self._graph is None:
            self._capture(x)
        self._static_x.copy_(x)
        self._graph.replay()
        return self._static_y.clone()


def build_mpmd_executor(
    plan: ExecutionPlan,
    model: CNNModel,
    params: Params,
    device: DeviceLike = "cuda",
    batch: int = 1,
    liveness: bool = True,
    fuse_transfers: bool = True,
    coalesce: bool = True,
) -> MPMDExecutor:
    """The plan as ``f(x) -> y`` on ``plan.n_workers`` CUDA streams.

    ``params`` must live on ``device`` and the input's leading dimension
    must equal ``batch`` (it is baked into the register shapes; the callable
    checks it eagerly).  ``liveness=False`` keeps every register until the
    call ends; ``liveness=True`` drops registers after their death
    superstep.  ``fuse_transfers`` picks the comm lowering (module
    docstring); ``coalesce=True`` merges consecutive transfer-only
    supersteps into one comm round first.  The output is the sink register
    of ``plan.sink_worker``, in f32 (every compute output is cast to f32).

    f32 parity with the reference needs TF32 off where cuDNN and cuBLAS
    would use it (``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``); the caller sets it.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if coalesce:
        plan = coalesce_transfer_steps(plan)
    return MPMDExecutor(plan, model, params, dev, batch, liveness, fuse_transfers)


def _check_batch(x, batch: int) -> None:
    """Eager batch-dimension check of the executor's input."""
    lead = x.shape[0] if getattr(x, "ndim", 0) else None
    if lead != batch:
        raise ValueError(
            f"this executor was built for batch={batch} (baked into its "
            f"register layout) but the input has leading dimension "
            f"{lead}; rebuild with build_mpmd_executor(..., "
            f"batch={lead})"
        )


def executed_comm_bytes(
    plan: ExecutionPlan,
    model: CNNModel,
    batch: int = 1,
    fuse_transfers: bool = True,
    coalesce: bool = True,
    dtype_bytes: int = 4,
) -> float:
    """Exact payload bytes the executor's destinations copy.

    Mirrors the comm lowering analytically: the per-node path ships one
    payload of the transfer's window per (node, window) group pair, so its
    total equals ``plan.comm_bytes`` times ``batch * dtype_bytes`` /
    producer-bytes — the byte-parity property the per-node window fix is
    tested against.  The fused path pads each round's payload to the
    round's largest pair, so it is an upper bound on the accounting.
    """
    if coalesce:
        plan = coalesce_transfer_steps(plan)
    sizes = {l.name: int(np.prod(l.out_shape)) for l in model.layers}

    def t_elems(t: Transfer) -> int:
        if t.box is None:
            return sizes[t.node]
        n = 1
        for lo, hi in t.box:
            n *= hi - lo
        return n

    total = 0
    for step in plan.steps:
        if fuse_transfers:
            pair_ts: Dict[Tuple[int, int], List[Transfer]] = {}
            for t in step.transfers:
                pair_ts.setdefault((t.src, t.dst), []).append(t)
            for round_pairs in _permutation_rounds(sorted(pair_ts)):
                length = max(
                    sum(t_elems(t) for t in pair_ts[p]) for p in round_pairs
                )
                total += length * len(round_pairs)
        else:
            by_key: Dict[Tuple[str, Optional[Tuple]], List[Transfer]] = {}
            for t in step.transfers:
                by_key.setdefault((t.node, t.box), []).append(t)
            for (_node, _box), ts in by_key.items():
                e = t_elems(ts[0])
                for perm in _permutation_rounds([(t.src, t.dst) for t in ts]):
                    total += e * len(perm)
    return float(total) * batch * dtype_bytes
