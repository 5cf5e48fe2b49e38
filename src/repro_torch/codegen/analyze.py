"""Happens-before hazard analysis over execution plans (``validate --deep``).

The paper's multi-core contribution is "templates implementing
synchronization mechanisms": generated code whose cross-core reads and
writes are ordered by construction.  In a certification context that
ordering must be *proved* sufficient, not tested into confidence — so this
module statically verifies the concurrency story of the whole pipeline, at
two levels, by abstract interpretation:

**Superstep level** (:func:`_analyze_steps` — no model needed).  Events are
per-(worker, superstep) compute reads/writes and per-comm-round ppermute
send/recv pairs.  Happens-before is same-worker program order (compute
phase < comm phase < next compute phase) plus one edge per transfer
(source's gather before destination's landing).  Verified:

* every compute read of a parent register is preceded (HB) by a local
  write — a compute on the same worker or a delivery by an *earlier* comm
  round (the paper's Writing-before-Reading flag protocol as a theorem
  about the plan, not a runtime wait);
* every transfer's source worker *computed* the value (a relay forwarding
  a received window would ship its pre-round register — two hops in one
  round have no HB edge);
* no two unordered writes target the same destination register (two
  same-round deliveries of one value from different sources) — the
  determinism guarantee that output is schedule-order independent.

It also emits the **sync-cost report**: per-delivery slack (supersteps
between delivery and first consuming read), transfers never consumed, and
comm rounds whose entire payload has slack — synchronization the plan pays
for but no dependency needs yet at that point (the paper's sync-template
cost, quantified; lookahead pre-shipping makes this intentionally > 0).

**Cell level** (:func:`_verify_access` — needs the model).  The segmented
executor's *actual* access tables (``executor.segment_access_tables``: the
``home``-redirected gather rows, rotating-frame landings, water-filled
retire tables and checkpoint materialization pairs — the very tables the
runtime compiles) are replayed over an abstract packed carry whose cells
hold symbolic value ids instead of floats.  Each (worker, column) cell is
written/read in exact runtime order — per tick: kernel gathers + register
write, then retire copies, then comm sender gathers, then landing blocks —
so every hazard class is a value-id mismatch with exact coordinates:

* **no data race / no stale read (WAR)**: a gather that resolves to a
  staging strip must find the delivered value still there — a rotating
  frame reused (``tick % depth``) before its last reader is caught as the
  read observing the clobbering write's id;
* **retire-window soundness**: a retire copy must run inside its safe
  window (after its delivery's landing, before the frame's reuse) — each
  strip column carries the packed column it belongs to, and a retire or
  checkpoint materialization whose source no longer belongs to its
  destination is flagged;
* **sync sufficiency**: a read expecting a remote value that finds the
  zero-initialized register means no comm round happened-before the
  consuming tick;
* **donation safety**: staging columns start as ``uninitialized`` (the
  donated carry keeps the previous call's bytes there); any consuming read
  that reaches one proves the in-trace re-init contract broken;
* **determinism**: landing blocks of one tick must not overlap, retire
  pad lanes must stay (dump, dump) pairs, and round-row padding must sit
  strictly at the tail — every write either has a program-order slot or
  touches a cell nothing reads.

The analyzer is deliberately *not* a re-derivation of the executor walk:
expected values come from the model's raw gather rows (register identity
encoded into fake offsets), while actual cell contents flow through the
executor's own tables — a bug in redirection, staging rotation, retirement
or checkpointing shows up as a mismatch.  ``tests/mutations.py`` keeps the
analyzer honest: ~10 seeded mutation classes (dropped rounds, shrunk
retire windows, aliased registers, swapped frame parity, deleted barriers,
mis-padded tables…) must each be caught.

Wired behind ``validate_plan(..., deep=True)``; run by the conftest
build_plan wrapper (superstep level) on every plan the suite builds, by
``ElasticPlanner`` before any degraded replan ships, and by
``examples/schedule_sliced.py --analyze`` (per-segment hazard/slack
report).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.codegen.plan import ExecutionPlan
from repro_torch.codegen.validate import PlanValidationError

__all__ = [
    "PlanHazardError",
    "Hazard",
    "AnalysisReport",
    "analyze_plan",
]

# symbolic cell values (anything >= 0 encodes a register element)
_UNDEF = -3    # previous call's bytes (donated staging, never written)
_ZEROV = -1    # literal zero (fresh registers / zero-sentinel region)
_NEGINF = -2   # -inf sentinel region
_DONT = -4     # padding don't-care (dump column and landed pad lanes)


class PlanHazardError(PlanValidationError):
    """The happens-before analysis found a concurrency hazard."""

    def __init__(self, report: "AnalysisReport"):
        self.report = report
        super().__init__(report.summary())


@dataclasses.dataclass
class Hazard:
    """One ordering violation, with exact plan coordinates."""
    kind: str
    detail: str
    step: Optional[int] = None
    segment: Optional[int] = None
    tick: Optional[int] = None
    worker: Optional[int] = None
    node: Optional[str] = None
    column: Optional[int] = None
    depth: Optional[int] = None

    def coords(self) -> str:
        parts = []
        for label, v in (
            ("depth", self.depth), ("superstep", self.step),
            ("segment", self.segment), ("tick", self.tick),
            ("worker", self.worker), ("column", self.column),
        ):
            if v is not None:
                parts.append(f"{label} {v}")
        if self.node is not None:
            parts.append(f"node {self.node!r}")
        return ", ".join(parts)

    def __str__(self) -> str:
        c = self.coords()
        return f"[{self.kind}] {c + ': ' if c else ''}{self.detail}"


@dataclasses.dataclass
class AnalysisReport:
    """Result of :func:`analyze_plan`."""
    hazards: List[Hazard]
    sync: Dict
    depths: Tuple[int, ...]
    stats: Dict
    segments: List[Dict]

    @property
    def ok(self) -> bool:
        return not self.hazards

    def summary(self, max_hazards: int = 6) -> str:
        lines = []
        if self.hazards:
            lines.append(
                f"{len(self.hazards)} concurrency hazard(s) found:"
            )
            for h in self.hazards[:max_hazards]:
                lines.append(f"  {h}")
            if len(self.hazards) > max_hazards:
                lines.append(f"  ... {len(self.hazards) - max_hazards} more")
        else:
            props = [
                "race-free", "sync-sufficient", "deterministic",
            ]
            if self.stats.get("cell_events"):
                props.insert(1, "donation-safe")
                lines.append(
                    f"hazard-free at buffer_depth {list(self.depths)}: "
                    + ", ".join(props)
                    + f" ({self.stats['cell_events']:,} cell accesses, "
                    f"{self.stats['plan_events']:,} superstep events)"
                )
            else:
                lines.append(
                    "hazard-free (superstep level): " + ", ".join(props)
                    + f" ({self.stats['plan_events']:,} events)"
                )
        s = self.sync
        if s:
            lines.append(
                f"sync cost: {s['transfers']} transfers over "
                f"{s['comm_rounds']} comm rounds; "
                f"{s['zero_slack_transfers']} payloads consumed on the "
                f"next superstep, slack mean {s['slack_mean']:.2f} / max "
                f"{s['slack_max']} supersteps; verdict: {s['verdict']}"
            )
        return "\n".join(lines)


def _transfer_elems(tr, shapes) -> Optional[int]:
    if shapes is None or tr.node not in shapes:
        return None
    shape = shapes[tr.node]
    if tr.box is None:
        return int(np.prod(shape)) if shape else 1
    n = 1
    for (lo, hi) in tr.box:
        n *= hi - lo
    for ext in shape[len(tr.box):]:
        n *= ext
    return int(n)


def _analyze_steps(
    plan: ExecutionPlan, dag, shapes=None,
) -> Tuple[List[Hazard], Dict]:
    """Superstep-level happens-before verification + sync-cost report."""
    m = plan.n_workers
    pm = dag.parent_map() if dag is not None else None
    hazards: List[Hazard] = []
    # node -> ("compute" | "deliver", step) of the latest HB write per worker
    write_kind: List[Dict[str, Tuple[str, int]]] = [{} for _ in range(m)]
    recs: List[Dict] = []
    pending: List[Dict[str, List[int]]] = [{} for _ in range(m)]
    n_events = 0
    for i, step in enumerate(plan.steps):
        # compute phase: reads happen-after only writes of *earlier* phases
        for w, seg_nodes in enumerate(step.compute):
            for n in seg_nodes:
                n_events += 1
                if pm is not None:
                    for u in pm.get(n, ()):
                        n_events += 1
                        if u not in write_kind[w]:
                            hazards.append(Hazard(
                                "raw-unordered", step=i, worker=w, node=n,
                                detail=(
                                    f"reads {u!r} but no write of {u!r} on "
                                    f"worker {w} happens-before this "
                                    "compute (no covering comm round)"
                                ),
                            ))
                        for ri in pending[w].get(u, ()):
                            if recs[ri]["first_use"] is None:
                                recs[ri]["first_use"] = i
                        pending[w][u] = []
                write_kind[w][n] = ("compute", i)
        # comm phase: one HB edge per transfer; unordered same-cell writes
        # (two same-round deliveries from different sources) are flagged
        seen: Dict[Tuple[str, int], int] = {}
        for tr in step.transfers:
            n_events += 2
            wk = write_kind[tr.src].get(tr.node)
            if wk is None or wk[0] != "compute":
                hazards.append(Hazard(
                    "send-unordered", step=i, worker=tr.src, node=tr.node,
                    detail=(
                        "transfer sources a worker that "
                        + ("only received the value (forwarding has no "
                           "happens-before edge in a fused round)"
                           if wk is not None else "never produced it")
                    ),
                ))
            key = (tr.node, tr.dst)
            prev = seen.get(key)
            if prev is not None and prev != tr.src:
                hazards.append(Hazard(
                    "waw-unordered", step=i, worker=tr.dst, node=tr.node,
                    detail=(
                        f"two unordered deliveries (from workers {prev} "
                        f"and {tr.src}) in one comm round write the same "
                        "destination register (schedule-order dependent)"
                    ),
                ))
            seen[key] = tr.src
            pending[tr.dst].setdefault(tr.node, []).append(len(recs))
            recs.append({
                "step": i, "node": tr.node, "src": tr.src, "dst": tr.dst,
                "elems": _transfer_elems(tr, shapes), "first_use": None,
            })
            write_kind[tr.dst][tr.node] = ("deliver", i)

    used = [r for r in recs if r["first_use"] is not None]
    unread = [r for r in recs if r["first_use"] is None]
    slacks = [r["first_use"] - r["step"] - 1 for r in used]
    round_steps = sorted({r["step"] for r in recs})
    per_round: Dict[int, float] = {}
    for r in recs:
        s = (
            float("inf") if r["first_use"] is None
            else r["first_use"] - r["step"] - 1
        )
        per_round[r["step"]] = min(per_round.get(r["step"], float("inf")), s)
    deferrable = [i for i in round_steps if per_round[i] >= 1]
    if not deferrable and not unread:
        verdict = (
            "minimal (every comm round carries at least one payload "
            "consumed on the next superstep, and every payload is read)"
        )
    else:
        parts = []
        if deferrable:
            parts.append(
                f"{len(deferrable)}/{len(round_steps)} comm rounds "
                "deferrable (every payload has >= 1 superstep of slack "
                "before its first reader — lookahead pre-shipping)"
            )
        if unread:
            elems = sum(r["elems"] or 0 for r in unread)
            parts.append(
                f"{len(unread)} transfers"
                + (f" ({elems} elements)" if elems else "")
                + " are never consumed (removable)"
            )
        verdict = "; ".join(parts)
    sync = {
        "comm_rounds": len(round_steps),
        "transfers": len(recs),
        "consumed_transfers": len(used),
        "unread_transfers": len(unread),
        "unread_elems": sum(r["elems"] or 0 for r in unread),
        "zero_slack_transfers": sum(1 for s in slacks if s == 0),
        "slack_mean": float(np.mean(slacks)) if slacks else 0.0,
        "slack_max": max(slacks, default=0),
        "deferrable_rounds": len(deferrable),
        "deferrable_round_steps": deferrable[:32],
        "verdict": verdict,
    }
    return hazards, sync, n_events


class _Stop(Exception):
    pass


def _verify_access(
    plan: ExecutionPlan, model, at, max_hazards: int = 25,
) -> Tuple[List[Hazard], List[Dict], Dict]:
    """Cell-level replay of one depth's access tables over symbolic ids."""
    from repro_torch.codegen.segment import node_gather_rows

    pt = at.tables
    depth = at.buffer_depth
    m = plan.n_workers
    total, dump_col = pt.total, pt.dump_col
    stage_base = dump_col + 1
    segments = pt.segments
    stage_end = segments[0].stage.stage_end if segments else stage_base
    wmax = max(
        [1] + [
            pt.reg_sizes[n]
            for seg in segments for row in seg.ticks for n in row if n
        ]
    )
    width = max(stage_end, total + wmax)
    names = sorted(pt.offsets)
    nid = {n: i for i, n in enumerate(names)}
    stride = max([1] + [pt.reg_sizes[n] for n in names])

    def decode(v: int) -> str:
        if v == _UNDEF:
            return "uninitialized bytes from the previous donated call"
        if v == _ZEROV:
            return "zeros (never written)"
        if v == _NEGINF:
            return "the -inf sentinel"
        if v == _DONT:
            return "padding don't-care bytes"
        return f"{names[int(v) // stride]!r}[{int(v) % stride}]"

    # expected lane values: register identity encoded into fake offsets so
    # each raw gather lane names (parent, element) independently of where
    # the executor's redirection claims the value lives
    enc_offsets = {n: nid[n] * stride for n in names}
    exp_cache: Dict[str, List[np.ndarray]] = {}

    def exp_rows(node: str) -> List[np.ndarray]:
        rws = exp_cache.get(node)
        if rws is None:
            rws = [
                np.asarray(r, np.int64)
                for r in node_gather_rows(model, node, enc_offsets)
            ]
            exp_cache[node] = rws
        return rws

    val = np.full((m, width), _UNDEF, np.int64)
    val[:, :pt.neginf_base] = _ZEROV       # registers + zero sentinels
    val[:, pt.neginf_base:dump_col] = _NEGINF
    val[:, dump_col] = _DONT
    # staging [stage_base, width) keeps _UNDEF: the donated carry leaves
    # the previous call's bytes there, so any consuming read that wins the
    # race against this call's landing is a donation-safety violation
    sowner = np.full((m, width), -1, np.int64)  # strip col -> packed col

    hazards: List[Hazard] = []
    seg_rows: List[Dict] = []
    n_reads = n_writes = n_deliv = 0

    def emit(kind: str, detail: str, **kw) -> None:
        hazards.append(Hazard(kind, detail, depth=depth, **kw))
        if len(hazards) >= max_hazards:
            raise _Stop()

    def check_cols(cols, hi, kind, **kw) -> np.ndarray:
        ok = (cols >= 0) & (cols < hi)
        if not ok.all():
            bad = int(cols[~ok][0])
            emit(
                kind, f"index {bad} outside [0, {hi}) — table corrupt",
                column=bad, **kw,
            )
        return ok

    try:
        for seg_i, seg in enumerate(segments):
            seg_h0 = len(hazards)
            acc = at.access[seg_i]
            act_np = seg.stage.act
            soff = seg.stage.soff
            round_rows = [np.asarray(r.rows, np.int64) for r in seg.rounds]
            round_slots = [np.asarray(r.slot) for r in seg.rounds]
            for t, row in enumerate(seg.ticks):
                # ---- kernel phase: every worker gathers its operands and
                # writes its output register (program order within worker)
                for w, node in enumerate(row):
                    if node is None:
                        continue
                    red = acc.gin_red.get((t, w))
                    exp = exp_rows(node)
                    if red is None or len(red) != len(exp):
                        emit(
                            "missing-gather",
                            f"no gather table for compute of {node!r}",
                            segment=seg_i, tick=t, worker=w, node=node,
                        )
                        continue
                    for r_arr, e_arr in zip(red, exp):
                        r_arr = np.asarray(r_arr, np.int64)
                        if r_arr.shape != e_arr.shape:
                            emit(
                                "missing-gather",
                                f"gather row shape {r_arr.shape} != "
                                f"expected {e_arr.shape} for {node!r}",
                                segment=seg_i, tick=t, worker=w, node=node,
                            )
                            continue
                        n_reads += r_arr.size
                        neg = r_arr < 0
                        bad = np.nonzero(neg & (r_arr != e_arr))[0]
                        for k in bad[:2]:
                            emit(
                                "sentinel-mismatch",
                                f"lane {int(k)} gathers sentinel "
                                f"{int(r_arr[k])} but the operand expects "
                                f"{decode(int(e_arr[k]))}",
                                segment=seg_i, tick=t, worker=w, node=node,
                            )
                        pos = np.nonzero(~neg)[0]
                        if not pos.size:
                            continue
                        cols = r_arr[pos]
                        okm = check_cols(
                            cols, width, "oob-gather",
                            segment=seg_i, tick=t, worker=w, node=node,
                        )
                        cols, want = cols[okm], e_arr[pos][okm]
                        got = val[w, cols]
                        mm = np.nonzero(got != want)[0]
                        for k in mm[:3]:
                            col = int(cols[k])
                            gv = int(got[k])
                            if gv == _UNDEF:
                                kind, why = "uninit-read", (
                                    "donation hazard: the gather reads "
                                    "staging bytes never written this call"
                                )
                            elif col >= stage_base:
                                kind, why = "stale-read", (
                                    "frame-reuse WAR: the staging strip "
                                    "was overwritten before this read"
                                )
                            elif gv == _ZEROV:
                                kind, why = "raw-unordered", (
                                    "no covering comm round or compute "
                                    "happens-before this read"
                                )
                            else:
                                kind, why = "wrong-value", "clobbered cell"
                            emit(
                                kind,
                                f"compute of {node!r} expects "
                                f"{decode(int(want[k]))} but column holds "
                                f"{decode(gv)} — {why}",
                                segment=seg_i, tick=t, worker=w,
                                node=node, column=col,
                            )
                    off_n, sz_n = pt.offsets[node], pt.reg_sizes[node]
                    val[w, off_n:off_n + sz_n] = (
                        nid[node] * stride + np.arange(sz_n, dtype=np.int64)
                    )
                    n_writes += sz_n
                # ---- retire phase: a reused frame's survivors move home
                # (runs after the kernel write, before the landing DUS)
                if acc.ret_src is not None:
                    for w in range(m):
                        s_r = np.asarray(acc.ret_src[t, w], np.int64)
                        d_r = np.asarray(acc.ret_dst[t, w], np.int64)
                        pad_s, pad_d = s_r == dump_col, d_r == dump_col
                        for k in np.nonzero(pad_s != pad_d)[0][:2]:
                            emit(
                                "retire-pad-incoherent",
                                f"retire lane {int(k)} pairs "
                                f"{'pad' if pad_s[k] else int(s_r[k])} -> "
                                f"{'pad' if pad_d[k] else int(d_r[k])}: "
                                "mis-padded table scatters don't-care "
                                "bytes into a live column",
                                segment=seg_i, tick=t, worker=w,
                            )
                        realm = ~pad_s & ~pad_d
                        cols_s, cols_d = s_r[realm], d_r[realm]
                        okm = (
                            check_cols(
                                cols_s, width, "oob-retire",
                                segment=seg_i, tick=t, worker=w,
                            )
                            & check_cols(
                                cols_d, total, "oob-retire",
                                segment=seg_i, tick=t, worker=w,
                            )
                        )
                        cols_s, cols_d = cols_s[okm], cols_d[okm]
                        own = sowner[w, cols_s]
                        for k in np.nonzero(own != cols_d)[0][:3]:
                            emit(
                                "retire-clobbered",
                                f"retire copies strip column "
                                f"{int(cols_s[k])} to packed column "
                                f"{int(cols_d[k])}, but the strip "
                                + (
                                    "was reused for packed column "
                                    f"{int(own[k])}"
                                    if own[k] >= 0 else
                                    "holds no delivery"
                                )
                                + f" (it holds {decode(int(val[w, cols_s[k]]))})"
                                " — retire window violated",
                                segment=seg_i, tick=t, worker=w,
                                column=int(cols_s[k]),
                            )
                        # model the damage exactly: every real-dst lane
                        # scatters whatever its source lane holds
                        lanes = ~pad_d
                        dd = d_r[lanes]
                        okd = (dd >= 0) & (dd < width)
                        val[w, dd[okd]] = val[w, np.clip(s_r[lanes][okd], 0, width - 1)]
                        n_reads += int(realm.sum())
                        n_writes += int(realm.sum())
                # ---- comm phase: sender gathers (own post-retire state),
                # then all landings apply at once (ppermute exchange)
                if seg.rounds and act_np[t].any():
                    blocks = sorted(
                        (int(soff[t, r_i]), seg.rounds[r_i].length, r_i)
                        for r_i in np.nonzero(act_np[t])[0]
                    )
                    for (a, b) in zip(blocks, blocks[1:]):
                        if a[0] + a[1] > b[0]:
                            emit(
                                "waw-overlap",
                                f"landing blocks of rounds {a[2]} and "
                                f"{b[2]} overlap ([{a[0]},{a[0] + a[1]}) "
                                f"vs [{b[0]},{b[0] + b[1]})): two "
                                "unordered writes per cell",
                                segment=seg_i, tick=t,
                            )
                    landings = []
                    for (strip, length, r_i) in blocks:
                        r = seg.rounds[r_i]
                        cols_block = strip + np.arange(length)
                        if strip < stage_base or (
                            cols_block[-1] >= width if length else False
                        ):
                            emit(
                                "oob-landing",
                                f"round {r_i} lands [{strip}, "
                                f"{strip + length}) outside staging "
                                f"[{stage_base}, {width})",
                                segment=seg_i, tick=t,
                            )
                            continue
                        for w in range(m):
                            rw = round_rows[r_i][round_slots[r_i][t, w]]
                            s = (w - r.delta) % m
                            realmask = rw != dump_col
                            n_real = int(realmask.sum())
                            if realmask[n_real:].any():
                                emit(
                                    "pad-interleaved",
                                    f"round {r_i} row interleaves padding "
                                    "with real positions (cohort padding "
                                    "must sit strictly at the tail)",
                                    segment=seg_i, tick=t, worker=w,
                                )
                            srcs = np.where(realmask, rw, dump_col)
                            okm = check_cols(
                                srcs, width, "oob-send",
                                segment=seg_i, tick=t, worker=int(s),
                            )
                            srcs = np.where(okm, srcs, dump_col)
                            payload = np.where(
                                realmask & okm, val[s, srcs], _DONT
                            )
                            sv = payload[realmask & okm]
                            for k in np.nonzero(sv < 0)[0][:2]:
                                emit(
                                    "send-unordered",
                                    f"worker {int(s)} ships "
                                    f"{decode(int(sv[k]))} — no compute "
                                    "of the payload happens-before the "
                                    "send",
                                    segment=seg_i, tick=t, worker=int(s),
                                )
                            n_reads += n_real
                            landings.append(
                                (w, cols_block, payload,
                                 np.where(realmask & okm, rw, -1))
                            )
                            n_deliv += n_real
                    for (w, cols_block, payload, owners) in landings:
                        val[w, cols_block] = payload
                        sowner[w, cols_block] = owners
                        n_writes += cols_block.size
            # ---- checkpoint materialization at the segment barrier
            if acc.mat is not None:
                src, dst = acc.mat
                for w in range(m):
                    s_r = np.asarray(src[w], np.int64)
                    d_r = np.asarray(dst[w], np.int64)
                    pad_s, pad_d = s_r == dump_col, d_r == dump_col
                    for k in np.nonzero(pad_s != pad_d)[0][:2]:
                        emit(
                            "mat-pad-incoherent",
                            f"checkpoint lane {int(k)} pairs pad with a "
                            "live column",
                            segment=seg_i, worker=w,
                        )
                    realm = ~pad_s & ~pad_d
                    cols_s, cols_d = s_r[realm], d_r[realm]
                    okm = (
                        check_cols(
                            cols_s, width, "oob-mat", segment=seg_i,
                            worker=w,
                        )
                        & check_cols(
                            cols_d, total, "oob-mat", segment=seg_i,
                            worker=w,
                        )
                    )
                    cols_s, cols_d = cols_s[okm], cols_d[okm]
                    own = sowner[w, cols_s]
                    for k in np.nonzero(own != cols_d)[0][:3]:
                        emit(
                            "mat-clobbered",
                            f"checkpoint materializes strip column "
                            f"{int(cols_s[k])} into packed column "
                            f"{int(cols_d[k])} but the strip holds "
                            f"{decode(int(val[w, cols_s[k]]))} — snapshot "
                            "would diverge from the barrier state",
                            segment=seg_i, worker=w,
                            column=int(cols_s[k]),
                        )
                    val[w, cols_d] = val[w, cols_s]
                    n_reads += cols_s.size
                    n_writes += cols_d.size
            seg_rows.append({
                "segment": seg_i,
                "steps": (seg.start, seg.stop),
                "ticks": len(seg.ticks),
                "rounds": len(seg.rounds),
                "retired_elems": acc.retire_elems,
                "hazards": len(hazards) - seg_h0,
            })
        # ---- the output: the sink register must hold exactly its value
        off, sz = pt.offsets[plan.sink], pt.reg_sizes[plan.sink]
        got = val[plan.sink_worker, off:off + sz]
        want = nid[plan.sink] * stride + np.arange(sz, dtype=np.int64)
        mm = np.nonzero(got != want)[0]
        for k in mm[:3]:
            emit(
                "sink-incomplete",
                f"sink element {int(k)} holds {decode(int(got[k]))} "
                f"instead of {plan.sink!r}[{int(k)}]",
                worker=plan.sink_worker, node=plan.sink,
                column=off + int(k),
            )
    except _Stop:
        pass
    stats = {
        "reads": n_reads, "writes": n_writes, "delivered_elems": n_deliv,
        "width": width, "segments": len(segments),
    }
    return hazards, seg_rows, stats


def analyze_plan(
    plan: ExecutionPlan,
    dag=None,
    model=None,
    *,
    depths: Sequence[int] = (1, 2, 4),
    checkpoint: bool = True,
    liveness: bool = True,
    cohort_rounds: bool = True,
    offsets: Optional[Dict[str, int]] = None,
    tamper: Optional[Callable] = None,
    max_hazards: int = 25,
    raise_on_hazard: bool = False,
) -> AnalysisReport:
    """Happens-before hazard analysis of a plan.

    Superstep-level analysis always runs (needs only ``dag`` for the read
    sets; without it, only send/WAW ordering and the sync report).  With
    ``model``, the cell-level replay additionally verifies the segmented
    executor's actual access tables at every ``buffer_depth`` in
    ``depths`` (any depth >= 1 — the analyzer is depth-agnostic).

    ``tamper`` (mutation-oracle hook) may rewrite the
    :class:`~repro_torch.codegen.executor.AccessTables` of each depth before
    verification; ``offsets`` overrides the packed layout.  With
    ``raise_on_hazard``, a non-empty hazard list raises
    :class:`PlanHazardError` (how ``validate_plan(deep=True)`` refuses a
    plan).
    """
    shapes = (
        {l.name: tuple(l.out_shape) for l in model.layers}
        if model is not None else None
    )
    hazards, sync, plan_events = _analyze_steps(plan, dag, shapes)
    stats: Dict = {"plan_events": plan_events, "cell_events": 0,
                   "per_depth": {}}
    seg_report: List[Dict] = []
    if model is not None:
        from repro_torch.codegen.executor import segment_access_tables

        for d in depths:
            try:
                at = segment_access_tables(
                    plan, model, liveness=liveness, buffer_depth=d,
                    cohort_rounds=cohort_rounds, checkpoint=checkpoint,
                    offsets=offsets,
                )
                if tamper is not None:
                    at = tamper(at) or at
                hz, rows, dstats = _verify_access(
                    plan, model, at, max_hazards=max_hazards,
                )
            except NotImplementedError as e:
                # the build itself refuses the schedule (e.g. a sender
                # would forward a value it received) — report, don't crash
                hazards.append(Hazard(
                    "build-rejected", detail=str(e), depth=d,
                ))
                continue
            except Exception:
                if hazards:
                    # a plan already known broken at the superstep level
                    # can fail table construction arbitrarily
                    hazards.append(Hazard(
                        "analysis-aborted", depth=d,
                        detail="cell-level table build failed on an "
                               "already-hazardous plan",
                    ))
                    continue
                raise
            hazards += hz
            stats["per_depth"][d] = dstats
            stats["cell_events"] += dstats["reads"] + dstats["writes"]
            if rows:
                seg_report = rows
    report = AnalysisReport(
        hazards=hazards, sync=sync,
        depths=tuple(depths) if model is not None else (),
        stats=stats, segments=seg_report,
    )
    if raise_on_hazard and hazards:
        raise PlanHazardError(report)
    return report
