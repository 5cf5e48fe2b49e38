"""Static validation of execution plans (the robustness gate).

ACETONE's argument for generated C is that every structural property is
checkable *before* deployment; a plan that the executor would mis-run should
be rejected at generation time, not discovered as a numeric divergence.
:func:`validate_plan` replays a plan symbolically and enforces the
invariants every executor in the repo relies on:

* **coverage** — every DAG node is computed at least once, at most once per
  worker, and only nodes of the DAG appear; the plan's sink is the DAG's
  sink and is computed on ``sink_worker``;
* **input availability** — a compute occurrence sees all of its parents
  locally (computed earlier on the same worker, or delivered by an earlier
  comm round) before it runs;
* **supplier liveness** — every transfer's source worker has *computed* the
  value by the end of the transfer's superstep (a worker that merely
  received a window must never supply: two hops of one value in a fused
  round would ship the relay's pre-round register);
* **transfer sanity** — endpoints in range, no self-transfers, boxes are
  non-empty well-ordered intervals and (given a model) fit inside the
  producer's output shape;
* **register layout** (given a model) — packed offsets place concurrently
  live registers in disjoint slots inside the buffer
  (:func:`~repro.codegen.plan.pack_registers` soundness);
* **segment schema** (given a model) — segments partition the supersteps in
  order, ticks are uniform (at most one node per worker per tick, ordered
  as the superstep's segments), and every ring-round index row points only
  at real register elements with padding strictly at the tail aimed past
  every register (the sentinel-column contract of the segmented executor);
* **cohort rounds** (given a model) — every emitted ring round ships at
  least one payload (build-time dead-round elision leaves nothing to skip
  at runtime), is padded exactly to its widest member row, carries no
  all-padding rows beyond the sentinel row 0, and rounds of the same delta
  fire on disjoint ticks (each tick's payload for a delta lives in exactly
  one cohort);
* **span tables** (given a model) — every signature slot the executor
  would span-coalesce reconstructs its resolved gather rows exactly from
  the static piece structure (``dynamic_slice`` spans + element-gather
  remainders), so the memcpy fast path is bit-equivalent to the element
  gather it replaces.

Failure messages carry structured coordinates — ``[superstep 12, segment
3, tick 7, worker 2, node 'conv2_s1']`` — so a finding inside a 165-task
plan names the exact access to look at.

``deep=True`` escalates from structural invariants to the happens-before
hazard analysis of :mod:`repro.codegen.analyze` (race freedom, sync
sufficiency, donation safety, determinism), raising
:class:`~repro.codegen.analyze.PlanHazardError` (a subclass of
:class:`PlanValidationError`) on any hazard.  Repeat validations of an
identical (plan, dag, model) are memoized by content fingerprint, so
wrapping every ``build_plan`` in the test suite stays flat-cost.

The structural pass is pure numpy (no jax), so CI and the elastic replan
path run it on every plan — original and replanned — before anything
executes.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.codegen.plan import (
    ExecutionPlan,
    RegisterLayout,
    build_segments,
    plan_fingerprint,
)
from repro_torch.core.graph import DAG

__all__ = ["PlanValidationError", "validate_plan"]


class PlanValidationError(ValueError):
    """A plan violates a structural invariant the executors rely on."""


_NAMED = ("node", "nodes", "register", "registers", "transfer")


def _fail(msg: str, **coords) -> None:
    """Raise with a structured coordinate prefix: every finding names the
    (superstep/segment/tick/worker/register/frame) it points at."""
    parts = []
    for k, v in coords.items():
        if v is None:
            continue
        label = k.replace("_", " ")
        parts.append(f"{label} {v!r}" if k in _NAMED else f"{label} {v}")
    prefix = f"[{', '.join(parts)}] " if parts else ""
    raise PlanValidationError(prefix + msg)


def _check_structure(plan: ExecutionPlan, dag: DAG) -> Dict[str, int]:
    nodes = set(dag.nodes)
    pm = dag.parent_map()
    m = plan.n_workers
    sinks = dag.sinks()
    if plan.sink not in sinks:
        _fail(
            f"plan sink is not a DAG sink {list(sinks)}", node=plan.sink
        )
    if not (0 <= plan.sink_worker < m):
        _fail(f"sink worker out of range for m={m}", worker=plan.sink_worker)

    have: Dict[int, Set[str]] = {w: set() for w in range(m)}
    computed: Dict[int, Set[str]] = {w: set() for w in range(m)}
    computed_any: Set[str] = set()
    n_transfers = 0
    for i, step in enumerate(plan.steps):
        if len(step.compute) != m:
            _fail(
                f"{len(step.compute)} compute segments for m={m} workers",
                superstep=i,
            )
        for w, seg in enumerate(step.compute):
            for n in seg:
                if n not in nodes:
                    _fail("unknown node", superstep=i, worker=w, node=n)
                if n in computed[w]:
                    _fail(
                        "node computed twice on one worker",
                        superstep=i, worker=w, node=n,
                    )
                missing = [u for u in pm[n] if u not in have[w]]
                if missing:
                    _fail(
                        f"computed without local inputs {missing} "
                        "(availability violated)",
                        superstep=i, worker=w, node=n,
                    )
                have[w].add(n)
                computed[w].add(n)
                computed_any.add(n)
        for t in step.transfers:
            n_transfers += 1
            if t.node not in nodes:
                _fail(
                    "transfer of unknown node", superstep=i,
                    transfer=t.label(), node=t.node,
                )
            if not (0 <= t.src < m) or not (0 <= t.dst < m):
                _fail(
                    f"transfer endpoints out of range for m={m}",
                    superstep=i, transfer=t.label(),
                )
            if t.src == t.dst:
                _fail("self-transfer", superstep=i, transfer=t.label())
            if t.node not in computed[t.src]:
                _fail(
                    "transfer sources a worker that never computed the "
                    "value (supplier liveness)",
                    superstep=i, worker=t.src, transfer=t.label(),
                    node=t.node,
                )
            if t.box is not None:
                for (lo, hi) in t.box:
                    if not (0 <= lo < hi):
                        _fail(
                            f"degenerate box interval ({lo}, {hi})",
                            superstep=i, transfer=t.label(),
                        )
            have[t.dst].add(t.node)

    missing = nodes - computed_any
    if missing:
        _fail(f"plan never computes {sorted(missing)}")
    if plan.sink not in computed[plan.sink_worker]:
        _fail(
            "sink is never computed on its designated worker",
            worker=plan.sink_worker, node=plan.sink,
        )
    return {"supersteps": len(plan.steps), "transfers": n_transfers}


def _check_boxes(plan: ExecutionPlan, shapes: Mapping[str, Tuple[int, ...]]) -> None:
    for i, step in enumerate(plan.steps):
        for t in step.transfers:
            if t.box is None:
                continue
            shape = shapes[t.node]
            if len(t.box) > len(shape):
                _fail(
                    f"box has {len(t.box)} axes but the producer is "
                    f"{len(shape)}-d",
                    superstep=i, transfer=t.label(), node=t.node,
                )
            for ax, (lo, hi) in enumerate(t.box):
                if hi > shape[ax]:
                    _fail(
                        f"box axis {ax} ({lo}, {hi}) exceeds producer "
                        f"extent {shape[ax]} (transfer window outside "
                        "producer output)",
                        superstep=i, transfer=t.label(), node=t.node,
                    )


def _check_layout(
    plan: ExecutionPlan,
    layout: RegisterLayout,
    liveness: Optional[Tuple[Mapping[str, int], Mapping[str, int]]],
) -> None:
    regs = sorted(layout.offsets)
    for n in regs:
        off, sz = layout.offsets[n], layout.size(n)
        if off < 0 or off + sz > layout.total:
            _fail(
                f"register [{off}, {off + sz}) outside the packed buffer "
                f"of {layout.total} elements (register sizing)",
                register=n, column=off,
            )
    if liveness is None:
        return
    birth, death = liveness
    for i, a in enumerate(regs):
        oa, sa = layout.offsets[a], layout.size(a)
        for b in regs[i + 1:]:
            if birth[a] <= death[b] and birth[b] <= death[a]:
                ob, sb = layout.offsets[b], layout.size(b)
                if not (oa + sa <= ob or ob + sb <= oa):
                    _fail(
                        f"live registers overlap in the packed buffer "
                        f"([{oa}, {oa + sa}) vs [{ob}, {ob + sb}), live "
                        f"steps {birth[a]}..{death[a]} vs "
                        f"{birth[b]}..{death[b]})",
                        registers=(a, b), column=max(oa, ob),
                    )


def _check_segments(
    plan: ExecutionPlan,
    layout: RegisterLayout,
    staging_depths: Sequence[int],
) -> None:
    pad = layout.total + 2  # the executor's dump column
    segments = build_segments(plan, layout.shapes, layout.offsets, pad_index=pad)
    for depth in staging_depths:
        _check_staging(
            build_segments(
                plan, layout.shapes, layout.offsets, pad_index=pad,
                buffer_depth=depth,
            ),
            pad, depth,
        )
    spans = [(s.start, s.stop) for s in segments]
    if spans and (spans[0][0] != 0 or spans[-1][1] != len(plan.steps)):
        _fail(f"segments {spans} do not cover supersteps [0, {len(plan.steps)})")
    for a, b in zip(spans, spans[1:]):
        if a[1] != b[0]:
            _fail(f"segments are not contiguous at supersteps {a} -> {b}")
    m = plan.n_workers
    for seg_i, seg in enumerate(segments):
        if list(seg.step_of_tick) != sorted(seg.step_of_tick):
            _fail(
                "segment ticks are not in superstep order (tick uniformity)",
                segment=seg_i,
            )
        for t, row in enumerate(seg.ticks):
            if len(row) != m:
                _fail(
                    f"{len(row)} worker cells for m={m} (tick uniformity)",
                    segment=seg_i, tick=t,
                )
        for r_i, r in enumerate(seg.rounds):
            rows = np.asarray(r.rows)
            if rows.shape[0] < 1 or not (rows[0] == pad).all():
                _fail(
                    "ring round row 0 is not all-padding",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            real = rows != pad
            if rows[real].size and (
                rows[real].min() < 0 or rows[real].max() >= layout.total
            ):
                _fail(
                    f"ring round indexes outside the register file "
                    f"[0, {layout.total}) (padding sentinel contract "
                    "violated)",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            # padding strictly at the tail of every (sorted) row
            for k in range(rows.shape[0]):
                row = rows[k]
                n_real = int((row != pad).sum())
                if (row[n_real:] != pad).any():
                    _fail(
                        f"ring round row {k} interleaves padding with real "
                        "positions",
                        segment=seg_i, round=r_i, delta=r.delta,
                    )
            # cohort invariants: dead rounds are elided at build time,
            # padding is tight (some member row fills the round), and no
            # referenced row beyond the sentinel row 0 is all-padding
            slot = np.asarray(r.slot)
            if r.length < 1:
                _fail(
                    f"ring round has length {r.length}",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            if not (slot != 0).any():
                _fail(
                    "ring round has no active (tick, dst) cell (dead "
                    "rounds must be elided at build time)",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            n_real_rows = (rows != pad).sum(axis=1)
            if rows.shape[0] > 1 and int(n_real_rows[1:].max()) != r.length:
                _fail(
                    f"ring round padded to {r.length} but its widest row "
                    f"ships {int(n_real_rows[1:].max())} (cohort padding "
                    "must be tight)",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            if rows.shape[0] > 1 and int(n_real_rows[1:].min()) == 0:
                _fail(
                    "ring round references an all-padding row beyond the "
                    "sentinel row 0",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
        # rounds of one delta fire on disjoint ticks: a tick's payload for
        # a delta belongs to exactly one cohort
        by_delta: Dict[int, np.ndarray] = {}
        for r_i, r in enumerate(seg.rounds):
            active = (np.asarray(r.slot) != 0).any(axis=1)
            prev = by_delta.get(r.delta)
            if prev is not None and bool((prev & active).any()):
                _fail(
                    "two ring rounds of one delta are active on the same "
                    "tick (cohorts must partition a delta's ticks)",
                    segment=seg_i, round=r_i, delta=r.delta,
                )
            by_delta[r.delta] = active if prev is None else (prev | active)


def _check_staging(segments, pad: int, depth: int) -> None:
    """Staging-layout invariants of :class:`SegmentStaging` at one depth.

    Write-once (``depth == 1``): every shipping tick's strips are
    allocated tick-major without overlap, so no delivered value is ever
    clobbered.  Rotating (any ``depth >= 2``): frames are sized to the
    globally largest tick payload, shipping ticks rotate all ``depth``
    frames round-robin (a frame is reused no sooner than ``depth``
    shipping ticks later — the slack the executor's retire tables rely
    on), and every block plus its read-back tail stays inside the staging
    region.
    """
    if depth < 1:
        _fail(f"buffer depth {depth} < 1")
    stage_base = pad + 1
    glob_pay = 0
    for seg_i, seg in enumerate(segments):
        st = seg.stage
        if st is None:
            _fail(
                f"segment spanning supersteps [{seg.start},{seg.stop}) "
                "has no staging layout",
                segment=seg_i, depth=depth,
            )
        if st.buffer_depth != depth or st.stage_base != stage_base:
            _fail(
                f"staging header mismatch: depth {st.buffer_depth} vs "
                f"{depth}, base {st.stage_base} vs {stage_base}",
                segment=seg_i,
            )
        lens = np.asarray([r.length for r in seg.rounds], np.int64)
        act = np.stack(
            [(np.asarray(r.slot) != 0).any(axis=1) for r in seg.rounds],
            axis=1,
        ) if seg.rounds else np.zeros((len(seg.ticks), 0), bool)
        if st.act.shape != act.shape or (st.act != act).any():
            _fail(
                "staging active-round mask disagrees with round slots",
                segment=seg_i, depth=depth,
            )
        pay = (act * lens[None, :]).sum(axis=1) if seg.rounds else (
            np.zeros(len(seg.ticks), np.int64)
        )
        if (st.payloads != pay).any():
            _fail(
                "staging per-tick payloads disagree with round lengths",
                segment=seg_i, depth=depth,
            )
        glob_pay = max(glob_pay, int(pay.max()) if pay.size else 0)
    off = stage_base
    g = 0
    for seg_i, seg in enumerate(segments):
        st = seg.stage
        lmax = st.lmax
        for t in range(len(seg.ticks)):
            pay_t = int(st.payloads[t])
            if depth == 1:
                if int(st.base[t]) != off or int(st.frame_of[t]) != -1:
                    _fail(
                        f"write-once staging: tick base {int(st.base[t])} "
                        f"!= running offset {off} (strips must be "
                        "tick-major and clobber-free)",
                        segment=seg_i, tick=t, depth=depth,
                    )
                o = off
            else:
                if pay_t == 0:
                    if int(st.frame_of[t]) != -1 or (
                        int(st.base[t]) != stage_base
                    ):
                        _fail(
                            "idle tick must park its read-back block at "
                            "the staging base",
                            segment=seg_i, tick=t, depth=depth,
                        )
                    continue
                fr = int(st.frame_of[t])
                if fr != g % depth:
                    _fail(
                        f"rotating staging: shipping tick {g} landed in "
                        f"frame {fr}, expected {g % depth} (round-robin "
                        f"rotation gives retire its {depth}-tick slack)",
                        segment=seg_i, tick=t, frame=fr, depth=depth,
                    )
                if pay_t > st.frame_elems:
                    _fail(
                        f"tick payload {pay_t} exceeds frame_elems "
                        f"{st.frame_elems}",
                        segment=seg_i, tick=t, frame=fr, depth=depth,
                    )
                if int(st.base[t]) != stage_base + fr * st.frame_elems:
                    _fail(
                        "rotating staging: tick base off its frame",
                        segment=seg_i, tick=t, frame=fr, depth=depth,
                    )
                g += 1
                o = int(st.base[t])
            for r_i in np.nonzero(st.act[t])[0]:
                if int(st.soff[t, r_i]) != o:
                    _fail(
                        f"round strip {int(st.soff[t, r_i])} != payload "
                        f"block offset {o} (landed blocks must be "
                        "contiguous in round order)",
                        segment=seg_i, tick=t, round=int(r_i), depth=depth,
                    )
                o += seg.rounds[r_i].length
            if depth == 1:
                off = o
            if int(st.base[t]) + lmax > st.stage_end:
                _fail(
                    "tick block + read-back tail spills past stage_end",
                    segment=seg_i, tick=t, depth=depth,
                )
    for seg_i, seg in enumerate(segments):
        st = seg.stage
        want_frame = glob_pay if depth > 1 else 0
        if st.frame_elems != want_frame:
            _fail(
                f"frame_elems {st.frame_elems} != globally largest tick "
                f"payload {want_frame}",
                segment=seg_i, depth=depth,
            )
        if depth > 1 and st.stage_end < stage_base + depth * st.frame_elems:
            _fail(
                "staging region smaller than depth * frame_elems",
                segment=seg_i, depth=depth,
            )
        if depth == 1 and st.stage_end < off:
            _fail(
                "write-once staging region smaller than its last strip",
                segment=seg_i, depth=depth,
            )


def _check_spans(plan: ExecutionPlan, model, layout: RegisterLayout) -> None:
    """Span-coalesced assembly is bit-equivalent to the element gather.

    For every node the plan computes, resolve its gather rows the way the
    segmented executor does (sentinel runs become ascending ranges in
    pristine regions) and, wherever :func:`~repro.codegen.segment.
    coalesce_spans` elects the memcpy fast path, re-expand the static piece
    structure and require it to reproduce the resolved rows exactly."""
    from repro_torch.codegen.segment import (
        coalesce_spans,
        max_sentinel_runs,
        node_gather_rows,
        resolve_rows,
    )

    zrun = nrun = 1
    raw: Dict[str, list] = {}
    for step in plan.steps:
        for seg_nodes in step.compute:
            for node in seg_nodes:
                if node in raw:
                    continue
                rws = node_gather_rows(model, node, layout.offsets)
                raw[node] = rws
                for rr in rws:
                    z, nf = max_sentinel_runs(np.atleast_2d(rr))
                    zrun, nrun = max(zrun, z), max(nrun, nf)
    zero_base = layout.total
    neginf_base = layout.total + zrun
    for node, rws in raw.items():
        for j, rr in enumerate(rws):
            rows = resolve_rows(np.atleast_2d(rr), zero_base, neginf_base)
            span = coalesce_spans(rows)
            if span is None:
                continue
            rebuilt = np.empty_like(rows)
            p = si = ri = 0
            for ln, kind in zip(span.lens, span.kinds):
                if kind == "span":
                    rebuilt[:, p:p + ln] = (
                        span.starts[:, si, None]
                        + np.arange(ln, dtype=np.int32)
                    )
                    si += 1
                else:
                    rebuilt[:, p:p + ln] = span.rem[:, ri:ri + ln]
                    ri += ln
                p += ln
            if p != rows.shape[1] or not (rebuilt == rows).all():
                _fail(
                    f"span table slot {j} does not reconstruct its gather "
                    "rows (span fast path would diverge from the element "
                    "gather)",
                    node=node,
                )


def _dag_fingerprint(dag: DAG) -> str:
    pm = dag.parent_map()
    h = hashlib.sha256()
    for n in sorted(dag.nodes):
        h.update(n.encode())
        h.update(b"<")
        h.update(",".join(pm.get(n, ())).encode())
        h.update(b";")
    return h.hexdigest()


def _model_fingerprint(model) -> str:
    if model is None:
        return "-"
    h = hashlib.sha256()
    for l in model.layers:
        h.update(
            f"{l.name}|{getattr(l, 'op', '')}|{tuple(l.out_shape)};".encode()
        )
    return h.hexdigest()


# validation memo: the conftest wrapper re-validates identical plans many
# times per session — a content-hash hit skips the whole pass
_MEMO: Dict[Tuple, Dict[str, int]] = {}
_MEMO_LIMIT = 512


def validate_plan(
    plan: ExecutionPlan,
    dag: DAG,
    model=None,
    liveness: bool = True,
    *,
    deep: bool = False,
    staging_depths: Sequence[int] = (1, 2, 4),
    cache: bool = True,
) -> Dict[str, int]:
    """Enforce the plan invariants; raise :class:`PlanValidationError`.

    With ``model`` (a :class:`~repro.models.cnn.CNNModel`), additionally
    checks transfer boxes against producer output shapes, packed-register
    sizing/overlap, and the segmented executor's tick/ring-round schema —
    the full contract the segmented ``lax.scan`` path compiles against —
    with the staging layout checked at every depth in ``staging_depths``
    (any ``buffer_depth >= 1``).

    ``deep=True`` additionally runs the happens-before hazard analysis
    (:func:`repro.codegen.analyze.analyze_plan`): superstep-level race /
    sync-sufficiency / determinism checks always, plus the cell-level
    access replay over ``staging_depths`` when ``model`` is given.  Any
    hazard raises :class:`~repro.codegen.analyze.PlanHazardError`.

    Results are memoized by (plan, dag, model) content fingerprint
    (``cache=False`` forces a re-run).  Returns summary statistics.
    """
    if deep:
        raise NotImplementedError(
            "deep=True runs the happens-before analyzer (codegen/analyze.py), "
            "which the port does not have yet"
        )
    key = None
    if cache:
        key = (
            plan_fingerprint(plan), _dag_fingerprint(dag),
            _model_fingerprint(model), liveness, deep,
            tuple(staging_depths),
        )
        hit = _MEMO.get(key)
        if hit is not None:
            return dict(hit)
    stats = _check_structure(plan, dag)
    if model is not None:
        shapes = {l.name: tuple(l.out_shape) for l in model.layers}
        _check_boxes(plan, shapes)
        live = None
        if liveness:
            from repro_torch.codegen.executor import plan_liveness

            birth, death, _sets = plan_liveness(plan, model)
            live = (birth, death)
        layout = RegisterLayout.of(plan, shapes, liveness=live)
        _check_layout(plan, layout, live)
        _check_segments(plan, layout, staging_depths)
        _check_spans(plan, model, layout)
        stats["packed_elements"] = layout.total
    if cache and key is not None:
        if len(_MEMO) >= _MEMO_LIMIT:
            _MEMO.clear()
        _MEMO[key] = dict(stats)
    return stats
