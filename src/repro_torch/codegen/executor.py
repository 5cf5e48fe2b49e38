"""Plan execution: a Python interpreter (the logic oracle) and the MPMD
executors, m workers as m CUDA streams on one card.

Port of ``repro/codegen/executor.py``.  The reference lowers a plan to one
``shard_map`` over a mesh axis of m devices: each superstep runs every
worker's compute segment as a branch of a ``lax.switch`` and then its comm
round as ``lax.ppermute`` collectives.  Here the m workers are m
``torch.cuda.Stream``\\ s of one card, and CUDA events play ACETONE's
Writing/Reading flags.  Two executors share that frame.

The **unrolled** executor (:class:`MPMDExecutor`) gives each worker a
register dict of its own tensors:

* **supersteps** — each worker's compute segment is issued on its own
  stream (cuDNN convolutions, cuBLAS products), then the comm round;
* **transfers** — the source stream packs what it sends into a fresh
  payload (Writing), records an event (the flag), and the destination
  stream waits on that event and copies the payload into its own registers
  (Reading).  A destination never holds an alias of a source tensor, and no
  stream reads a register of another.  A windowed transfer writes only its
  box into a register that was born zero, so a box-inference bug shows
  numerically, as in the reference;
* **fused or per-node comm** — ``fuse_transfers=True`` ships one flat
  payload per ``(src, dst)`` pair of each permutation round, padded to the
  round's largest pair as ``ppermute`` pads it, and unpacks it on arrival;
  ``fuse_transfers=False`` ships one payload per ``(node, box)`` group.
  Either way the bytes the destinations copy equal
  :func:`executed_comm_bytes`;
* **liveness** — registers are dropped on every worker after the reference's
  death superstep (:func:`plan_liveness`); a register is materialized on a
  worker when that worker first writes it.

The **segmented** executor (:class:`SegmentedExecutor`,
``segmented=True``) runs the reference's segmented schema on the same
streams: each worker's registers are one packed carry tensor ``[batch,
width]`` (``pack_registers``), every gather row, span, ring-round row,
retire and checkpoint table is built on the device once, and the host,
which knows every (tick, worker)'s kernel and every tick's active rounds,
issues exactly those — no ``lax.switch``, idle branch, pattern switch or
self-restoring tail, which exist only to make a ``lax.scan`` uniform.  Its
host tables (``plan_tables``, ``plan_access_walk``,
``segment_access_tables``: numpy only) are the reference's, verbatim,
because the happens-before analyzer (``codegen/analyze.py``) proves its
hazards on them.

On the card both executors capture the whole static plan, at their first
call, into one CUDA graph spanning the m streams and replay it after that:
the counterpart of ``jax.jit``.  ``.eager(x)`` runs the same program
uncaptured.  On the CPU (``device="cpu"``) the same program runs eagerly,
in order, with no streams.
"""
from __future__ import annotations

import contextlib
import math
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.codegen.plan import (
    ExecutionPlan,
    RegisterLayout,
    Transfer,
    _permutation_rounds,
    build_segments,
    coalesce_transfer_steps,
    pack_registers,
)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.cnn import CNNModel, Params, apply_layer

__all__ = [
    "interpret_plan",
    "build_mpmd_executor",
    "plan_liveness",
    "executed_comm_bytes",
    "MPMDExecutor",
    "SegmentedExecutor",
    "PlanTables",
    "SegmentAccess",
    "AccessTables",
    "plan_tables",
    "plan_access_walk",
    "segment_access_tables",
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

    def barrier(self) -> None:
        """Join every stream: each waits for all work issued so far on the
        calling stream and on every other worker's stream (the calling
        stream waits for them all too)."""
        if not self.cuda:
            return
        caller = torch.cuda.current_stream(self.streams[0].device)
        for s in self.streams:
            caller.wait_stream(s)
        for s in self.streams:
            s.wait_stream(caller)

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
    segmented: bool = False,
    checkpoint: bool = False,
    span_coalesce: bool = True,
    cohort_rounds: bool = True,
    bake_params: bool = False,
    buffer_depth: int = 1,
):
    """The plan as ``f(x) -> y`` on ``plan.n_workers`` CUDA streams.

    ``params`` must live on ``device`` and the input's leading dimension
    must equal ``batch`` (it is baked into the register shapes; the callable
    checks it eagerly).  ``liveness=False`` keeps every register until the
    call ends; ``liveness=True`` drops registers after their death
    superstep.  ``fuse_transfers`` picks the comm lowering (module
    docstring); ``coalesce=True`` merges consecutive transfer-only
    supersteps into one comm round first.  The output is the sink register
    of ``plan.sink_worker``, in f32 (every compute output is cast to f32).

    ``segmented=True`` returns the segmented executor
    (:class:`SegmentedExecutor`; ``fuse_transfers`` does not apply):
    registers live in one packed carry per worker (``liveness`` controls
    slot reuse), and comm is the segments' ring rounds.  ``span_coalesce``
    / ``cohort_rounds`` / ``bake_params`` are the reference's ablation
    knobs, and ``buffer_depth`` 2 or 4 its streaming mode (rotating staging
    frames, retire copies, a carry that persists across calls); outputs,
    and the register region of checkpoint snapshots, are bit-identical
    across all of them.  ``checkpoint=True`` makes the executor return
    ``(y, snaps)`` with the packed carries at every segment boundary.

    f32 parity with the reference needs TF32 off where cuDNN and cuBLAS
    would use it (``torch.backends.cudnn.allow_tf32 = False``,
    ``torch.backends.cuda.matmul.allow_tf32 = False``); the caller sets it.
    """
    if checkpoint and not segmented:
        raise ValueError(
            "checkpoint=True requires segmented=True: only the segmented "
            "executor carries the packed register buffer that superstep "
            "snapshots are defined over"
        )
    if not (isinstance(buffer_depth, int) and buffer_depth >= 1):
        raise ValueError(
            f"buffer_depth must be a positive int (1 = write-once staging, "
            f"2/4 = double/quad-buffered streaming), got {buffer_depth!r}"
        )
    if buffer_depth != 1 and not segmented:
        raise ValueError(
            "buffer_depth >= 2 requires segmented=True: only the segmented "
            "executor stages comm payloads in the packed carry that the "
            "rotating frames double/quad-buffer"
        )
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if coalesce:
        plan = coalesce_transfer_steps(plan)
    if segmented:
        return SegmentedExecutor(
            plan, model, params, dev, batch, liveness, checkpoint=checkpoint,
            span_coalesce=span_coalesce, cohort_rounds=cohort_rounds,
            bake_params=bake_params, buffer_depth=buffer_depth,
        )
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
    segmented: bool = False,
    liveness: bool = True,
    cohort_rounds: bool = True,
    buffer_depth: int = 1,
) -> float:
    """Exact payload bytes the executors' collectives ship.

    Mirrors the comm lowering analytically: the per-node path ships one
    payload of the transfer's window per (node, window) group pair, so its
    total equals ``plan.comm_bytes`` times ``batch * dtype_bytes`` /
    producer-bytes — the byte-parity property the per-node window fix is
    tested against.  The fused path pads each round's payload to the
    round's largest pair, so it is an upper bound on the accounting.

    ``segmented=True`` counts the segmented executor's cohort-sized ring
    rounds instead (``fuse_transfers`` does not apply): only the *real*
    (non-padding) entries of each active ``(tick, dst)`` index row — pad
    entries gather from and scatter into the dump column, shipping no
    register data — so the total is exactly ``plan.comm_bytes`` scaled by
    ``batch * dtype_bytes`` / producer-bytes, whatever the cohort shapes.
    ``buffer_depth`` only relocates where a payload *lands* (write-once
    strip vs rotating frame): every delivery is counted exactly once here
    whatever the depth — the streaming executor's extra retire copies are
    local buffer moves, not shipped bytes — so the byte parity with
    ``plan.comm_bytes`` holds at every depth.
    """
    if coalesce:
        plan = coalesce_transfer_steps(plan)
    sizes = {l.name: int(np.prod(l.out_shape)) for l in model.layers}
    if segmented:
        reg_shapes = {l.name: tuple(l.out_shape) for l in model.layers}
        live = None
        if liveness:
            birth, death, _sets = plan_liveness(plan, model)
            live = (birth, death)
        offsets, total = pack_registers(
            plan, {n: max(s, 1) for n, s in sizes.items()}, liveness=live
        )
        pad = total  # stand-in dump column; positions are in [0, total)
        segments = build_segments(
            plan, reg_shapes, offsets, pad_index=pad,
            buffer_depth=buffer_depth,
            **({} if cohort_rounds else {"cohort_ratio": None}),
        )
        real = 0
        for seg in segments:
            for r in seg.rounds:
                per_row = (np.asarray(r.rows) != pad).sum(axis=1)
                real += int(per_row[np.asarray(r.slot)].sum())
        return float(real) * batch * dtype_bytes

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


# --------------------------------------------------------------------------- #
# host tables of the segmented executor (numpy only), shared with the analyzer
# --------------------------------------------------------------------------- #
def _waterfill(loads: np.ndarray, lo: int, hi: int, n: int) -> np.ndarray:
    """Split ``n`` units across slots ``loads[lo:hi+1]`` minimizing the
    resulting per-slot maximum (the counts are returned, ``loads`` is not
    mutated).  Used to flatten retire bursts over their safe scheduling
    windows: the scan body pads every tick to the widest per-tick retire
    table, so the cost of retirement is the *max* load, not the sum."""
    win = np.asarray(loads[lo:hi + 1], np.int64)
    level_lo, level_hi = int(win.min()), int(win.max()) + n
    while level_lo < level_hi:
        mid = (level_lo + level_hi) // 2
        if int(np.maximum(0, mid - win).sum()) >= n:
            level_hi = mid
        else:
            level_lo = mid + 1
    add = np.maximum(0, level_lo - win)
    excess = int(add.sum()) - n
    for i in range(len(add)):
        if excess <= 0:
            break
        take = min(excess, int(add[i]))
        add[i] -= take
        excess -= take
    return add


@dataclasses.dataclass
class PlanTables:
    """Plan-side canonicalization shared by the segmented executor build
    and the static analyzer (:mod:`repro_torch.codegen.analyze`): packed register
    layout, sentinel regions, segment schema and per-node raw gather rows —
    all derived with numpy only.  One derivation serves both, so the
    executor and the happens-before analysis can never disagree about
    where a value lives."""
    offsets: Dict[str, int]
    total: int
    zero_base: int
    neginf_base: int
    dump_col: int
    reg_shapes: Dict[str, Tuple[int, ...]]
    reg_sizes: Dict[str, int]
    birth: Dict[str, int]
    death: Dict[str, int]
    segments: List
    raw_rows: Dict[str, List[np.ndarray]]

    @property
    def zrun(self) -> int:
        return self.neginf_base - self.total

    @property
    def nrun(self) -> int:
        return self.dump_col - self.neginf_base


@dataclasses.dataclass
class SegmentAccess:
    """Build-time access metadata for one segment: every gather the
    kernels will issue (statically redirected through the schedule walk's
    per-worker ``home`` map), the water-filled retire copy tables, and the
    checkpoint materialization pairs.  This is the executor's exact
    memory-access schedule, exposed so the analyzer can verify the tables
    the runtime actually compiles rather than a parallel reconstruction."""
    gin_red: Dict[Tuple[int, int], List[np.ndarray]]  # (tick, worker)
    ret_src: Optional[np.ndarray]   # (n_ticks, m, k) int32, dump-padded
    ret_dst: Optional[np.ndarray]
    retire_elems: int
    mat: Optional[Tuple[np.ndarray, np.ndarray]]  # (m, k) src/dst pairs


@dataclasses.dataclass
class AccessTables:
    """A plan's full access schedule at one ``buffer_depth``."""
    tables: PlanTables
    access: List[SegmentAccess]
    buffer_depth: int
    checkpoint: bool


def plan_tables(
    plan: ExecutionPlan,
    model: CNNModel,
    liveness: bool = True,
    buffer_depth: int = 1,
    cohort_rounds: bool = True,
    offsets: Optional[Dict[str, int]] = None,
) -> PlanTables:
    """Derive the packed layout, sentinel regions, raw gather rows and
    segment schema for a plan (numpy only — no tracing).  ``offsets``
    overrides the packed layout (the analyzer's mutation oracle uses this
    to alias registers without re-deriving everything else)."""
    from repro_torch.codegen.segment import max_sentinel_runs, node_gather_rows

    reg_shapes = {l.name: tuple(l.out_shape) for l in model.layers}
    reg_sizes = {
        n: (int(np.prod(s)) if s else 1) for n, s in reg_shapes.items()
    }
    birth, death, _sets = plan_liveness(plan, model)
    if offsets is None:
        live = (birth, death) if liveness else None
        offsets, total = pack_registers(plan, reg_sizes, liveness=live)
    else:
        total = max(offsets[n] + reg_sizes[n] for n in offsets)

    # raw gather rows once per node; the longest sentinel *runs* size the
    # sentinel regions so every halo-pad run can resolve to a contiguous
    # ascending range and join a span (see segment.resolve_rows)
    raw_rows: Dict[str, List[np.ndarray]] = {}
    zrun = nrun = 1
    for step in plan.steps:
        for seg_nodes in step.compute:
            for node in seg_nodes:
                if node in raw_rows:
                    continue
                rws = node_gather_rows(model, node, offsets)
                raw_rows[node] = rws
                for r in rws:
                    z, nf = max_sentinel_runs(r)
                    zrun, nrun = max(zrun, z), max(nrun, nf)
    # pristine sentinel regions follow the registers: ``[total, total+zrun)``
    # holds 0.0 (virtualized conv/avgpool halo pads), the next ``nrun``
    # columns hold -inf (maxpool halo pads), and the final column is the
    # dump column comm padding gathers from and scatters into — so every
    # index is in bounds and padding can never touch a real register
    zero_base = total
    neginf_base = total + zrun
    dump_col = total + zrun + nrun
    segments = build_segments(
        plan, reg_shapes, offsets, pad_index=dump_col,
        buffer_depth=buffer_depth,
        **({} if cohort_rounds else {"cohort_ratio": None}),
    )
    return PlanTables(
        offsets=offsets, total=total, zero_base=zero_base,
        neginf_base=neginf_base, dump_col=dump_col,
        reg_shapes=reg_shapes, reg_sizes=reg_sizes,
        birth=birth, death=death, segments=segments, raw_rows=raw_rows,
    )


def plan_access_walk(
    plan: ExecutionPlan,
    pt: PlanTables,
    buffer_depth: int = 1,
    checkpoint: bool = False,
) -> List[SegmentAccess]:
    """Replay the tick schedule and emit each segment's access metadata.

    The walk mirrors the runtime tick order exactly — compute first, then
    the retire copies of a reused frame's surviving occupants, then the
    comm rounds' landings — while maintaining the per-worker ``home`` map:
    where each packed register column's current value actually lives (its
    own column, or a staging strip column when the value arrived via a
    comm round and has not been recomputed since).  Every gather table is
    redirected through the home state its tick will observe.

    Rotating frames (``buffer_depth >= 2``) additionally track per-frame
    occupancy: when a shipping tick reuses a frame, every delivery record
    still current in ``home`` is retired — copied back to its packed
    register columns just before the landing DUS clobbers the frame.
    Retiring is always semantics-preserving (the packed column is reserved
    until the value's death, and the runner materializes deliveries there
    anyway), so no liveness analysis is needed: over-retiring a dead value
    writes a column nothing will read again.  Retire bursts are
    water-filled backward across their safe windows (delivery + 1 ..
    eviction) so the uniform scan table pays the mean, not the burst max.
    """
    m = plan.n_workers
    total, dump_col = pt.total, pt.dump_col
    ident = np.arange(total, dtype=np.int32)
    home = np.tile(ident, (m, 1))
    owner = np.full((m, total), -1, np.int64)    # node id of last delivery
    pos2node = np.full(total, -1, np.int64)      # current producer per col
    node_ids: Dict[str, int] = {}

    def nid_of(node: str) -> int:
        i = node_ids.get(node)
        if i is None:
            i = node_ids[node] = len(node_ids)
        return i

    def redirect(w: int, rws: List[np.ndarray]) -> List[np.ndarray]:
        out = []
        for rr in rws:
            a = np.asarray(rr, np.int32).copy()
            msk = a >= 0
            a[msk] = home[w, a[msk]]
            out.append(a)
        return out

    # rotating-frame occupancy: per frame, the (worker, packed cols, strip
    # cols, delivery segment, delivery tick) records currently living there
    frame_occ: List[List[Tuple[int, np.ndarray, np.ndarray, int, int]]] = [
        [] for _ in range(buffer_depth)
    ]
    out: List[SegmentAccess] = []
    for seg_i, seg in enumerate(pt.segments):
        n_ticks = len(seg.ticks)
        act_np = seg.stage.act
        soff = seg.stage.soff
        round_rows = [np.asarray(r.rows) for r in seg.rounds]
        round_slots = [np.asarray(r.slot) for r in seg.rounds]
        # (worker, strip cols, packed cols, window lo, window hi): retire
        # chunks with the tick range each copy may legally run in
        ret_chunks: List[
            Tuple[int, np.ndarray, np.ndarray, int, int]
        ] = []
        gin_red: Dict[Tuple[int, int], List[np.ndarray]] = {}
        for t, row in enumerate(seg.ticks):
            for w, node in enumerate(row):
                if node is None:
                    continue
                gin_red[(t, w)] = redirect(w, pt.raw_rows[node])
                off_n, sz_n = pt.offsets[node], pt.reg_sizes[node]
                home[w, off_n:off_n + sz_n] = ident[off_n:off_n + sz_n]
                pos2node[off_n:off_n + sz_n] = nid_of(node)
            if buffer_depth > 1 and seg.stage.payloads[t]:
                # this shipping tick reuses rotating frame ``fr``: retire
                # its still-current occupants to their packed columns
                # (compute at this tick already resolved its gathers
                # against the strips — the runtime retire copy runs
                # after the kernel write, before the landing DUS)
                fr = int(seg.stage.frame_of[t])
                for (w, pcs, scs, d_seg, d_t) in frame_occ[fr]:
                    valid = home[w, pcs] == scs
                    if valid.any():
                        # a pair still current now was current ever since
                        # its delivery (``home`` entries are only touched
                        # by delivery, compute reuse, and retirement), so
                        # the copy may run at any tick after the strip
                        # landed and no later than this one
                        lo = d_t + 1 if d_seg == seg_i else 0
                        ret_chunks.append(
                            (w, scs[valid], pcs[valid], min(lo, t), t)
                        )
                        home[w, pcs[valid]] = pcs[valid]
                frame_occ[fr] = []
            for r_i, r in enumerate(seg.rounds):
                if not act_np[t, r_i]:
                    continue
                strip = soff[t, r_i]
                for w in range(m):
                    rw = round_rows[r_i][round_slots[r_i][t, w]]
                    real = np.nonzero(rw != dump_col)[0]
                    if not real.size:
                        continue
                    cols = rw[real]
                    s = (w - r.delta) % m
                    if not (home[s, cols] == cols).all():
                        raise NotImplementedError(
                            "staged comm: sender would forward a value it "
                            "received rather than produced"
                        )
                    strips = strip + real.astype(np.int32)
                    home[w, cols] = strips
                    owner[w, cols] = pos2node[cols]
                    if buffer_depth > 1:
                        frame_occ[int(seg.stage.frame_of[t])].append(
                            (w, np.asarray(cols, np.int32), strips, seg_i, t)
                        )
        # per-tick retire tables (rotating frames only): dst-sorted
        # (strip, packed) column pairs per worker, dump-padded to the
        # segment max — one gather + one sorted scatter per tick moves a
        # reused frame's surviving occupants home.  The scan body pads
        # every tick to the segment's widest retire, so eviction bursts
        # are first water-filled backward across their safe windows
        # (delivery + 1 .. eviction), flattening the per-tick maximum
        # toward the mean instead of the burst size.
        ret_by_tw: Dict[Tuple[int, int], List[Tuple[np.ndarray, np.ndarray]]]
        ret_by_tw = {}
        if ret_chunks:
            loads = np.zeros((n_ticks, m), np.int64)
            for (w, scs, pcs, lo, hi) in ret_chunks:
                counts = _waterfill(loads[:, w], lo, hi, len(scs))
                off = 0
                for t_r, c in zip(range(lo, hi + 1), counts):
                    c = int(c)
                    if not c:
                        continue
                    ret_by_tw.setdefault((t_r, w), []).append(
                        (scs[off:off + c], pcs[off:off + c])
                    )
                    loads[t_r, w] += c
                    off += c
        retire_elems = 0
        ret_k = max(
            [0] + [
                sum(len(s) for (s, _d) in chunks)
                for chunks in ret_by_tw.values()
            ]
        )
        ret_src = ret_dst = None
        if ret_k:
            ret_src = np.full((n_ticks, m, ret_k), dump_col, np.int32)
            ret_dst = np.full((n_ticks, m, ret_k), dump_col, np.int32)
            for (t, w), chunks in ret_by_tw.items():
                scs = np.concatenate([s for (s, _d) in chunks])
                pcs = np.concatenate([d for (_s, d) in chunks])
                order = np.argsort(pcs, kind="stable")
                ret_src[t, w, : len(scs)] = scs[order]
                ret_dst[t, w, : len(pcs)] = pcs[order]
                retire_elems += len(pcs)
        # barrier materialization (checkpoint runs only): copy every
        # staged delivery back to its packed column, so snapshots stay
        # bit-equivalent to the reference runner's barrier state (which
        # writes deliveries straight into the register file, live or not)
        # and fault-time replan/resume (migrate_registers) sees a
        # canonical register file
        mat = None
        if checkpoint:
            pairs = []
            for w in range(m):
                moved = np.nonzero(home[w] != ident)[0]
                keep = sorted(p for p in moved if owner[w, p] >= 0)
                pairs.append([(home[w, p], p) for p in keep])
            k_max = max(len(p) for p in pairs)
            if k_max:
                src = np.full((m, k_max), dump_col, np.int32)
                dst = np.full((m, k_max), dump_col, np.int32)
                for w, pr in enumerate(pairs):
                    for j, (s_c, d_c) in enumerate(pr):
                        src[w, j] = s_c
                        dst[w, j] = d_c
                mat = (src, dst)
        out.append(SegmentAccess(
            gin_red=gin_red, ret_src=ret_src, ret_dst=ret_dst,
            retire_elems=retire_elems, mat=mat,
        ))
    return out


def segment_access_tables(
    plan: ExecutionPlan,
    model: CNNModel,
    *,
    liveness: bool = True,
    buffer_depth: int = 1,
    cohort_rounds: bool = True,
    checkpoint: bool = True,
    offsets: Optional[Dict[str, int]] = None,
) -> AccessTables:
    """The executor's access metadata for one plan at one ``buffer_depth``
    — the single entry point the happens-before analyzer consumes."""
    pt = plan_tables(
        plan, model, liveness=liveness, buffer_depth=buffer_depth,
        cohort_rounds=cohort_rounds, offsets=offsets,
    )
    access = plan_access_walk(
        plan, pt, buffer_depth=buffer_depth, checkpoint=checkpoint,
    )
    return AccessTables(
        tables=pt, access=access, buffer_depth=buffer_depth,
        checkpoint=checkpoint,
    )



# --------------------------------------------------------------------------- #
# segmented executor: one packed carry per worker, on m streams
# --------------------------------------------------------------------------- #
class SegmentedExecutor:
    """``f(x) -> y``, or ``(y, snaps)`` with ``checkpoint=True``: the plan's
    segments (``build_segments``) on m workers, each worker's registers one
    packed carry tensor ``[batch, width]`` on its own stream.

    Built by :func:`build_mpmd_executor` with ``segmented=True``.  Every
    table (gather rows, span remainders, ring-round rows, retire and
    checkpoint pairs) is a device tensor made once, here; span starts,
    output offsets and parameter blocks are fixed per (tick, worker), so the
    host issues them as offsets and tensors.  Each tick, in the order
    ``codegen/analyze.py`` proves free of hazards:

    1. each worker's kernel on its stream: the slots gathered from its
       carry, the kernel (:func:`~repro_torch.codegen.segment.make_kernel`),
       the output written into the carry;
    2. the retire copies of a reused staging frame (``buffer_depth >= 2``);
    3. each sender's gather of its destination's ring row, on the sender's
       stream, then an event on that stream (its Writing flag);
    4. each landing, on the destination's stream after it waits on the
       sender's flag, into the tick's staging strip.

    No stream reads another worker's carry: a payload is a fresh tensor
    handed over with ``record_stream``.  There is no per-tick barrier.  At
    a segment boundary, with ``checkpoint``, each worker copies its staged
    deliveries back to their packed columns (the access walk's ``mat``
    pairs) and snapshots its carry, on its own stream.

    ``snaps`` is one static ``[n_segments, m, batch, width]`` tensor owned
    by the executor: the next call (eager or a replay) overwrites it, so a
    caller that keeps a snapshot past that copies it.  ``y`` is a fresh
    tensor.  At ``buffer_depth >= 2`` the carries persist across calls and
    each call re-initializes only the register and zero-sentinel prefix and
    the -inf block (staging columns keep their bytes: every strip is
    written before it is read); at depth 1 each call starts from zeros, as
    the reference's fresh carry does.

    ``.layout``, ``.width``, ``.segment_spans``, ``.checkpoint_steps`` and
    ``.segment_stats`` are the reference's.  After each issue,
    ``comm_bytes`` holds the bytes the landings copied (the padded ring
    payloads, ``comm_shipped_elems`` × batch × 4) and ``streams_used`` the
    streams that received work; ``comm_real_bytes`` (the payloads' real
    entries) equals ``executed_comm_bytes(segmented=True)``.
    """

    def __init__(self, plan: ExecutionPlan, model: CNNModel, params: Params,
                 device: torch.device, batch: int, liveness: bool, *,
                 checkpoint: bool = False, span_coalesce: bool = True,
                 cohort_rounds: bool = True, bake_params: bool = False,
                 buffer_depth: int = 1):
        from repro_torch.codegen.segment import (
            SpanTable,
            coalesce_spans,
            make_kernel,
            node_signature,
            param_operands,
            resolve_rows,
        )

        m = plan.n_workers
        self.plan, self.device, self.batch = plan, device, batch
        self.checkpoint, self.buffer_depth = checkpoint, buffer_depth
        self._workers = _Workers(m, device)
        self.streams = self._workers.streams
        # plan-side canonicalization + the build-time schedule walk (shared
        # with codegen/analyze.py, which verifies these exact tables)
        pt = plan_tables(
            plan, model, liveness=liveness, buffer_depth=buffer_depth,
            cohort_rounds=cohort_rounds,
        )
        offsets, total = pt.offsets, pt.total
        reg_shapes, reg_sizes = pt.reg_shapes, pt.reg_sizes
        zero_base, neginf_base = pt.zero_base, pt.neginf_base
        dump_col, nrun = pt.dump_col, pt.nrun
        segments = pt.segments
        access = plan_access_walk(
            plan, pt, buffer_depth=buffer_depth, checkpoint=checkpoint,
        )
        # the reference's carry width: it leaves room for a uniform-width
        # output write past every register, which the port does not need
        # but keeps, so that snapshots have the reference's shape
        wmax = max(
            [1] + [
                reg_sizes[n]
                for seg in segments for row in seg.ticks for n in row if n
            ]
        )
        stage_end = segments[0].stage.stage_end if segments else dump_col + 1
        width = max(stage_end, total + wmax)
        self.width, self._neginf, self._nrun = width, neginf_base, nrun

        def dev_index(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

        kernels: Dict = {}
        pcache: Dict = {}
        self._ticks: List[List[Tuple]] = []   # per segment: per tick (compute, retire, sends)
        self._mat: List[List[Tuple[int, torch.Tensor, torch.Tensor]]] = []
        seg_stats = []
        for seg_i, seg in enumerate(segments):
            n_ticks = len(seg.ticks)
            act_np = seg.stage.act
            acc = access[seg_i]
            # active-round patterns: only their count is a statistic here
            patterns = {
                tuple(np.nonzero(act_np[t])[0].tolist()) for t in range(n_ticks)
            }
            sig_list: List = []
            sig_index: Dict = {}
            occs: List[Dict] = []
            sig_tab = np.zeros((n_ticks, m), np.int32)
            cells: Dict[Tuple[int, int], Tuple[int, int, str]] = {}
            for t, row in enumerate(seg.ticks):
                for w, node in enumerate(row):
                    if node is None:
                        continue
                    sig, pkey = node_signature(model, node)
                    key = (sig, pkey) if bake_params else sig
                    sid = sig_index.get(key)
                    if sid is None:
                        sid = sig_index[key] = len(sig_list)
                        sig_list.append(sig)
                        occs.append({"gin": [], "pkey": []})
                    o = occs[sid]
                    o["gin"].append(acc.gin_red[(t, w)])
                    o["pkey"].append(pkey)
                    sig_tab[t, w] = sid + 1  # 0 is the reference's idle branch
                    cells[(t, w)] = (sid, len(o["gin"]) - 1, node)
            # per signature and slot: the stacked, sentinel-resolved gather
            # rows of its occurrences, as spans or whole-slot rows
            slot_specs: List[List] = []   # [sid][slot] -> per-occurrence _Slot
            span_elems = gather_elems = 0
            for sig, o in zip(sig_list, occs):
                per_slot = []
                for j in range(len(sig[1])):
                    rows = resolve_rows(
                        np.stack([r[j] for r in o["gin"]]),
                        zero_base, neginf_base,
                    )
                    span = None
                    if rows.shape[1]:
                        if span_coalesce:
                            span = coalesce_spans(rows)
                        else:
                            # pre-span fast path: only whole-slot-contiguous
                            # rows become a (single-span) slice
                            runs = rows[:, :1] + np.arange(
                                rows.shape[1], dtype=np.int32
                            )
                            if (rows == runs).all():
                                span = SpanTable(
                                    lens=(rows.shape[1],), kinds=("span",),
                                    starts=rows[:, :1].copy(),
                                    rem=np.zeros((rows.shape[0], 0), np.int32),
                                    coverage=1.0,
                                )
                    gather_elems += rows.size
                    if span is None:
                        tab = dev_index(rows)
                        per_slot.append([("rows", tab[oc]) for oc in range(len(rows))])
                        continue
                    span_elems += int(round(span.coverage * rows.size))
                    rem = dev_index(span.rem) if span.rem.size else None
                    occ_slots = []
                    for oc in range(len(rows)):
                        pieces, si, ri = [], 0, 0
                        for ln, k in zip(span.lens, span.kinds):
                            if k == "span":
                                pieces.append(("span", int(span.starts[oc, si]), ln))
                                si += 1
                            else:
                                pieces.append(("rem", ri, ln))
                                ri += ln
                        occ_slots.append(("spans", tuple(pieces),
                                          None if rem is None else rem[oc]))
                    per_slot.append(occ_slots)
                slot_specs.append(per_slot)
            single = len(sig_list) == 1 and bool((sig_tab != 0).all())
            # the tick program: (compute, retire, sends) per tick
            rows_dev = [dev_index(r.rows) for r in seg.rounds]
            rsrc = rdst = None
            if acc.ret_src is not None:
                rsrc, rdst = dev_index(acc.ret_src), dev_index(acc.ret_dst)
            ticks = []
            for t in range(n_ticks):
                compute = []
                for w in range(m):
                    cell = cells.get((t, w))
                    if cell is None:
                        continue
                    sid, oc, node = cell
                    sig = sig_list[sid]
                    if sig not in kernels:
                        kernels[sig] = make_kernel(sig)
                    pkey = occs[sid]["pkey"][oc]
                    if pkey not in pcache:
                        pcache[pkey] = param_operands(params, pkey)
                    slots = tuple(
                        (spec[oc], shape)
                        for spec, shape in zip(slot_specs[sid], sig[1])
                    )
                    compute.append((w, kernels[sig], slots, pcache[pkey],
                                    offsets[node], reg_sizes[node]))
                retire = []
                if rsrc is not None:
                    # dump-padded after the real pairs: issue the real ones only
                    for w in range(m):
                        n = int((acc.ret_dst[t, w] != dump_col).sum())
                        if n:
                            retire.append((w, rsrc[t, w, :n], rdst[t, w, :n]))
                sends = []
                for r_i, r in enumerate(seg.rounds):
                    if act_np[t, r_i]:
                        strip = int(seg.stage.soff[t, r_i])
                        for d in range(m):
                            row = rows_dev[r_i][int(r.slot[t, d])]
                            sends.append(((d - r.delta) % m, d, row, strip, r.length))
                ticks.append((compute, retire, sends))
            self._ticks.append(ticks)
            mat = []
            if acc.mat is not None:
                src, dst = acc.mat
                for w in range(m):
                    n = int((dst[w] != dump_col).sum())
                    if n:
                        mat.append((w, dev_index(src[w, :n]), dev_index(dst[w, :n])))
            self._mat.append(mat)
            retire_elems = acc.retire_elems
            real_elems = shipped_elems = 0
            for r_i, r in enumerate(seg.rounds):
                per_row = (np.asarray(r.rows) != dump_col).sum(axis=1)
                real_elems += int(per_row[np.asarray(r.slot)].sum())
                shipped_elems += int(act_np[:, r_i].sum()) * r.length * m
            seg_stats.append({
                "steps": (seg.start, seg.stop),
                "ticks": n_ticks,
                "sigs": len(sig_list),
                "single_structure": single,
                "rounds": len(seg.rounds),
                "round_lengths": [r.length for r in seg.rounds],
                "round_fires": int(act_np.sum()),
                "comm_patterns": len(patterns),
                "comm_real_elems": real_elems,
                "comm_shipped_elems": shipped_elems,
                "stage_elems": int(sum(
                    int(act_np[:, r_i].sum()) * r.length
                    for r_i, r in enumerate(seg.rounds)
                )),
                # resident staging footprint (global, counted once — NOT per
                # fire): write-once strips for depth 1, depth * frame for the
                # rotating layout; plus the retire traffic rotation adds
                "buffer_depth": buffer_depth,
                "peak_staging_elems": int(stage_end - (dump_col + 1)),
                "retire_elems": retire_elems,
                "span_elems": span_elems,
                "gather_elems": gather_elems,
                "span_coverage": (
                    span_elems / gather_elems if gather_elems else 1.0
                ),
            })
        self.layout = RegisterLayout(
            offsets=offsets, total=total,
            shapes={n: reg_shapes[n] for n in offsets},
        )
        self.segment_spans = tuple((s.start, s.stop) for s in segments)
        # superstep each checkpoint snapshot is the entering barrier of:
        # snaps[k] == the runner's barrier entering superstep checkpoint_steps[k]
        self.checkpoint_steps = tuple(s.stop for s in segments)
        self.segment_stats = seg_stats
        self.comm_real_bytes = sum(st["comm_real_elems"] for st in seg_stats) * batch * 4
        self.in_shape = (batch, *reg_shapes[model.layers[0].name])
        self._sink = (plan.sink_worker, offsets[plan.sink], reg_sizes[plan.sink],
                      reg_shapes[plan.sink])
        self._bufs = [torch.zeros((batch, width), dtype=torch.float32, device=device)
                      for _ in range(m)]
        self.snaps = (
            torch.zeros((len(segments), m, batch, width), dtype=torch.float32, device=device)
            if checkpoint else None
        )
        self.carry_bytes = m * batch * width * 4
        self.comm_bytes = 0
        self.streams_used: Set[int] = set()
        self._graph = None
        self._static_x = self._static_y = None

    # -- one issue of the program -------------------------------------------- #
    def _assemble(self, buf: torch.Tensor, slot) -> torch.Tensor:
        """One input slot of a kernel, gathered from the carry: always a
        fresh contiguous tensor, so a kernel sees the same memory layout
        whichever way (rows, spans, depth) its values were found.

        ``slot`` is ``(spec, shape)``: ``("rows", index)`` gathers the whole
        slot; ``("spans", pieces, rem_index)`` concatenates ``(kind, start,
        length)`` pieces in row order, a ``"span"`` piece being the carry's
        columns ``[start, start + length)`` and a ``"rem"`` piece those
        columns of one gather of ``rem_index``."""
        (spec, shape) = slot
        if spec[0] == "rows":
            flat = buf.index_select(1, spec[1])
        else:
            _tag, pieces, rem_idx = spec
            rem = None if rem_idx is None else buf.index_select(1, rem_idx)
            parts = [buf[:, a:a + ln] if k == "span" else rem[:, a:a + ln]
                     for (k, a, ln) in pieces]
            flat = parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, 1)
        return flat.view(self.batch, *shape)

    def _gather_payload(self, s: int, row: torch.Tensor) -> torch.Tensor:
        """Writing: the sender's columns its destination receives, as a
        fresh tensor (pad entries gather the dump column)."""
        return self._bufs[s].index_select(1, row)

    def _issue(self, x: torch.Tensor) -> torch.Tensor:
        """Issue the whole program once; returns the sink register as a
        fresh tensor.  On the card the calling stream waits on every worker
        at the end."""
        W, bufs, batch = self._workers, self._bufs, self.batch
        m = len(bufs)
        caller = torch.cuda.current_stream(self.device) if W.cuda else None
        if W.cuda:
            for st in W.streams:
                st.wait_stream(caller)
        for w, buf in enumerate(bufs):
            with W.on(w):
                if self.buffer_depth == 1:
                    buf.zero_()
                else:
                    buf[:, :self._neginf].zero_()
                buf[:, self._neginf:self._neginf + self._nrun].fill_(-math.inf)
        copied, used = 0, set(range(m))
        for k, seg_ticks in enumerate(self._ticks):
            for compute, retire, sends in seg_ticks:
                for (w, kern, slots, pops, off, size) in compute:
                    buf = bufs[w]
                    with W.on(w):
                        ins = [self._assemble(buf, sl) for sl in slots]
                        y = kern(x, ins, pops)
                        buf[:, off:off + size].copy_(y.reshape(batch, size))
                for (w, src, dst) in retire:
                    buf = bufs[w]
                    with W.on(w):
                        buf.index_copy_(1, dst, buf.index_select(1, src))
                if not sends:
                    continue
                payloads, flags = [], {}
                for (s, d, row, strip, ln) in sends:
                    with W.on(s):
                        payloads.append(self._gather_payload(s, row))
                for s in {s for (s, *_rest) in sends}:
                    flags[s] = W.flag(s)
                for (s, d, _row, strip, ln), p in zip(sends, payloads):
                    with W.on(d):
                        W.wait(d, flags[s])
                        W.hand_over(p, d)
                        bufs[d][:, strip:strip + ln].copy_(p)
                    copied += p.numel() * p.element_size()
            if self.checkpoint:
                for (w, src, dst) in self._mat[k]:
                    with W.on(w):
                        bufs[w].index_copy_(1, dst, bufs[w].index_select(1, src))
                for w, buf in enumerate(bufs):
                    with W.on(w):
                        self.snaps[k, w].copy_(buf)
        sink_w, off, size, shape = self._sink
        with W.on(sink_w):
            out = bufs[sink_w][:, off:off + size].reshape(batch, *shape).clone()
        if W.cuda:
            for st in W.streams:
                caller.wait_stream(st)
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

    def _result(self, y: torch.Tensor):
        return (y, self.snaps) if self.checkpoint else y

    def eager(self, x: torch.Tensor):
        """The program issued op by op on the workers' streams, uncaptured."""
        self._check(x)
        return self._result(self._issue(x))

    def _capture(self, x: torch.Tensor) -> None:
        """Capture the program into one CUDA graph over the m streams, with
        a static copy of ``x`` as its input.  One eager issue on the same
        streams runs first, so that the libraries' per-stream handles and
        workspaces exist before capture.  Raises if capture fails."""
        self._static_x = x.clone()
        self._issue(self._static_x)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_y = self._issue(self._static_x)
        self._graph = graph

    def __call__(self, x: torch.Tensor):
        self._check(x)
        if not self._workers.cuda:
            return self._result(self._issue(x))
        if self._graph is None:
            self._capture(x)
        self._static_x.copy_(x)
        self._graph.replay()
        return self._result(self._static_y.clone())
