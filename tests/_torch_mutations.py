"""Seeded plan-mutation oracle for the happens-before analyzer.

The port's copy of ``tests/mutations.py``: the same mutations, built on
``repro_torch``'s plan classes and access tables (``test_torch_analyze.py``
holds them to the reference's on the same seeds).

Each mutation class injects one *specific* concurrency bug into a clean
plan (or into the executor's built access tables), chosen so that a sound
analyzer must flag it and a vacuous one would pass it.  The test matrix
(`tests/test_analyze.py`) asserts every class is caught on lenet5 and
grid-sliced inception across buffer depths — this is how we know
`codegen/analyze.py` isn't green by construction.

Plan-level classes rewrite the ``ExecutionPlan`` (frozen dataclasses, via
``dataclasses.replace``); table-level classes leave the plan intact and
tamper with the ``AccessTables`` the analyzer replays (modelling executor
bugs the plan IR can't express: a retire copy sliding out of its
water-filled window, a landing hitting the wrong rotating frame, a
mis-padded cohort row, a dropped round fire).  All choices are seeded —
the same (plan, class, seed) yields the same mutation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.codegen.plan import ExecutionPlan, Superstep, Transfer

MUTATION_CLASSES = (
    "drop_comm_round",        # delete one comm round wholesale
    "drop_transfer",          # delete a single consumed transfer
    "merge_steps",            # delete the barrier between two supersteps
    "misroute_transfer",      # source a transfer from a worker without the value
    "double_deliver",         # two same-round deliveries to one register
    "alias_registers",        # overlap two live registers in the packed layout
    "swap_frame_parity",      # land payloads in the wrong rotating frame
    "shrink_retire_window",   # retire copy one tick past its safe window
    "mispad_cohort",          # padding interleaved into a cohort row
    "drop_round_fire",        # one (tick, round) landing silently skipped
)


@dataclasses.dataclass
class Mutation:
    cls: str
    detail: str
    plan: ExecutionPlan
    offsets: Optional[Dict[str, int]] = None
    tamper: Optional[Callable] = None
    min_depth: int = 1        # needs buffer_depth >= this to be expressible


# --------------------------------------------------------------------------- #
# shared eligibility helpers
# --------------------------------------------------------------------------- #
def _consumed_transfers(plan: ExecutionPlan, dag) -> List[Tuple[int, int]]:
    """(step, transfer index) pairs whose payload some later compute on the
    destination worker actually reads, where the destination never computes
    the value itself (so deleting/misrouting the transfer must starve it)."""
    pm = dag.parent_map()
    computes: Dict[int, set] = {
        w: set() for w in range(plan.n_workers)
    }
    for step in plan.steps:
        for w, nodes in enumerate(step.compute):
            computes[w].update(nodes)
    out = []
    for i, step in enumerate(plan.steps):
        for j, tr in enumerate(step.transfers):
            if tr.node in computes[tr.dst]:
                continue
            for k in range(i + 1, len(plan.steps)):
                if any(
                    tr.node in pm.get(n, ())
                    for n in plan.steps[k].compute[tr.dst]
                ):
                    out.append((i, j))
                    break
    return out


def _replace_step(plan: ExecutionPlan, i: int, step: Superstep):
    steps = list(plan.steps)
    steps[i] = step
    return dataclasses.replace(plan, steps=tuple(steps))


# --------------------------------------------------------------------------- #
# plan-level mutations
# --------------------------------------------------------------------------- #
def _drop_comm_round(plan, dag, model, rng):
    cands = sorted({i for (i, _) in _consumed_transfers(plan, dag)})
    if not cands:
        return None
    i = int(rng.choice(cands))
    step = dataclasses.replace(plan.steps[i], transfers=())
    return Mutation(
        "drop_comm_round",
        f"deleted comm round of superstep {i} "
        f"({len(plan.steps[i].transfers)} transfers)",
        _replace_step(plan, i, step),
    )


def _drop_transfer(plan, dag, model, rng):
    cands = _consumed_transfers(plan, dag)
    if not cands:
        return None
    i, j = cands[int(rng.integers(len(cands)))]
    tr = plan.steps[i].transfers[j]
    step = dataclasses.replace(
        plan.steps[i],
        transfers=plan.steps[i].transfers[:j]
        + plan.steps[i].transfers[j + 1:],
    )
    return Mutation(
        "drop_transfer",
        f"deleted transfer {tr.label()} at superstep {i}",
        _replace_step(plan, i, step),
    )


def _merge_steps(plan, dag, model, rng):
    pm = dag.parent_map()
    cands = []
    for i in range(len(plan.steps) - 1):
        for tr in plan.steps[i].transfers:
            if any(
                tr.node in pm.get(n, ())
                for n in plan.steps[i + 1].compute[tr.dst]
            ):
                cands.append(i)
                break
    if not cands:
        return None
    i = int(rng.choice(cands))
    a, b = plan.steps[i], plan.steps[i + 1]
    merged = Superstep(
        compute=tuple(
            tuple(a.compute[w]) + tuple(b.compute[w])
            for w in range(plan.n_workers)
        ),
        transfers=a.transfers + b.transfers,
    )
    steps = plan.steps[:i] + (merged,) + plan.steps[i + 2:]
    return Mutation(
        "merge_steps",
        f"merged supersteps {i} and {i + 1} (barrier deleted: a value "
        "delivered by the round is consumed in the same phase)",
        dataclasses.replace(plan, steps=steps),
    )


def _misroute_transfer(plan, dag, model, rng):
    cands = _consumed_transfers(plan, dag)
    if not cands:
        return None
    computed_by: Dict[str, set] = {}
    for step in plan.steps:
        for w, nodes in enumerate(step.compute):
            for n in nodes:
                computed_by.setdefault(n, set()).add(w)
    rng.shuffle(cands)
    for (i, j) in cands:
        tr = plan.steps[i].transfers[j]
        bad = [
            w for w in range(plan.n_workers)
            if w not in computed_by.get(tr.node, set()) and w != tr.dst
        ]
        if not bad:
            continue
        src2 = int(rng.choice(bad))
        trs = list(plan.steps[i].transfers)
        trs[j] = dataclasses.replace(tr, src=src2)
        step = dataclasses.replace(plan.steps[i], transfers=tuple(trs))
        return Mutation(
            "misroute_transfer",
            f"transfer {tr.label()} at superstep {i} re-sourced from "
            f"worker {src2}, which never produced {tr.node!r}",
            _replace_step(plan, i, step),
        )
    return None


def _double_deliver(plan, dag, model, rng):
    cands = _consumed_transfers(plan, dag)
    if not cands:
        return None
    i, j = cands[int(rng.integers(len(cands)))]
    tr = plan.steps[i].transfers[j]
    others = [w for w in range(plan.n_workers) if w not in (tr.src, tr.dst)]
    if not others:
        return None
    src2 = int(rng.choice(others))
    dup = dataclasses.replace(tr, src=src2)
    step = dataclasses.replace(
        plan.steps[i], transfers=plan.steps[i].transfers + (dup,)
    )
    return Mutation(
        "double_deliver",
        f"duplicated {tr.label()} at superstep {i} from worker {src2}: "
        "two unordered same-round writes to one register",
        _replace_step(plan, i, step),
    )


def _alias_registers(plan, dag, model, rng):
    from repro_torch.codegen.executor import plan_tables

    pt = plan_tables(plan, model)
    names = sorted(pt.offsets)
    # register writes are per-worker rows of the packed value matrix, so a
    # column overlap is only a real clobber on a worker that both writes v
    # and still reads u afterwards — record who computes what and who
    # reads which parents when, and demand that coincidence
    pm = dag.parent_map()
    writer = {}
    reads = [[] for _ in range(plan.n_workers)]  # worker -> [(step, parent)]
    for i, st in enumerate(plan.steps):
        for w, nodes in enumerate(st.compute):
            for nd in nodes:
                writer[nd] = (i, w)
                for p in pm.get(nd, ()):
                    reads[w].append((i, p))
    cands = []
    for u in names:
        for v in names:
            if u == v or pt.offsets[u] == pt.offsets[v]:
                continue
            # v born strictly while u is still read later: v's write must
            # clobber a value u's reader consumes afterwards
            if not (pt.birth[u] < pt.birth[v] < pt.death[u]):
                continue
            if v not in writer:
                continue
            bstep, w = writer[v]
            if any(p == u and j > bstep for (j, p) in reads[w]):
                cands.append((u, v))
    if not cands:
        return None
    u, v = cands[int(rng.integers(len(cands)))]
    offsets = dict(pt.offsets)
    offsets[v] = offsets[u]
    return Mutation(
        "alias_registers",
        f"aliased {v!r} onto {u!r} at packed column {offsets[u]} "
        f"(live ranges overlap: steps {pt.birth[u]}..{pt.death[u]} vs "
        f"birth {pt.birth[v]})",
        plan,
        offsets=offsets,
    )


# --------------------------------------------------------------------------- #
# table-level tampers (executor-bug models the plan IR can't express)
# --------------------------------------------------------------------------- #
def _swap_parity_site(at):
    for seg_i, seg in enumerate(at.tables.segments):
        st = seg.stage
        if st.frame_elems <= 0:
            continue
        frames = set(int(f) for f in st.frame_of if f >= 0)
        if {0, 1} <= frames:
            return seg_i
    return None


def _tamper_swap_frame_parity(at):
    seg_i = _swap_parity_site(at)
    if seg_i is None:
        return at
    seg = at.tables.segments[seg_i]
    st = seg.stage
    soff = np.array(st.soff, copy=True)
    base = np.array(st.base, copy=True)
    for t in range(len(st.frame_of)):
        fr = int(st.frame_of[t])
        if fr == 0:
            soff[t] = soff[t] + st.frame_elems
            base[t] = base[t] + st.frame_elems
        elif fr == 1:
            soff[t] = soff[t] - st.frame_elems
            base[t] = base[t] - st.frame_elems
    segs = list(at.tables.segments)
    segs[seg_i] = dataclasses.replace(
        seg, stage=dataclasses.replace(st, soff=soff, base=base)
    )
    at.tables.segments = tuple(segs)
    return at


def _retire_window_site(at):
    """A retire lane scheduled at a shipping tick whose source strip lies
    inside that tick's landed payload block — the copy runs at the last
    legal tick (just before the frame-reuse landing), so delaying it by
    one tick makes it read the clobbered strip."""
    dump = at.tables.dump_col
    for seg_i, seg in enumerate(at.tables.segments):
        acc = at.access[seg_i]
        if acc.ret_src is None:
            continue
        st = seg.stage
        n_ticks = acc.ret_src.shape[0]
        for t in range(n_ticks - 1):
            if not st.payloads[t]:
                continue
            lo, hi = int(st.base[t]), int(st.base[t]) + int(st.payloads[t])
            for w in range(acc.ret_src.shape[1]):
                for k in range(acc.ret_src.shape[2]):
                    s = int(acc.ret_src[t, w, k])
                    if s != dump and lo <= s < hi:
                        return (seg_i, t, w, k)
    return None


def _tamper_shrink_retire_window(at):
    site = _retire_window_site(at)
    if site is None:
        return at
    seg_i, t, w, k = site
    acc = at.access[seg_i]
    dump = at.tables.dump_col
    # widen the lane axis by one so tick t+1 always has a free slot
    n_ticks, m, kk = acc.ret_src.shape
    src = np.full((n_ticks, m, kk + 1), dump, acc.ret_src.dtype)
    dst = np.full((n_ticks, m, kk + 1), dump, acc.ret_dst.dtype)
    src[:, :, :kk], dst[:, :, :kk] = acc.ret_src, acc.ret_dst
    src[t + 1, w, kk], dst[t + 1, w, kk] = src[t, w, k], dst[t, w, k]
    src[t, w, k] = dst[t, w, k] = dump
    acc.ret_src, acc.ret_dst = src, dst
    return at


def _mispad_site(at):
    dump = at.tables.dump_col
    for seg_i, seg in enumerate(at.tables.segments):
        for r_i, r in enumerate(seg.rounds):
            rows = np.asarray(r.rows)
            slot = np.asarray(r.slot)
            for row_id in range(1, rows.shape[0]):
                if (rows[row_id] != dump).sum() >= 2 and (
                    slot == row_id
                ).any():
                    return (seg_i, r_i, row_id)
    return None


def _tamper_mispad_cohort(at):
    site = _mispad_site(at)
    if site is None:
        return at
    seg_i, r_i, row_id = site
    seg = at.tables.segments[seg_i]
    r = seg.rounds[r_i]
    rows = np.array(r.rows, copy=True)
    rows[row_id, 0] = at.tables.dump_col  # pad before real lanes
    rounds = list(seg.rounds)
    rounds[r_i] = dataclasses.replace(r, rows=rows)
    segs = list(at.tables.segments)
    segs[seg_i] = dataclasses.replace(seg, rounds=tuple(rounds))
    at.tables.segments = tuple(segs)
    return at


def _fire_site(at):
    dump = at.tables.dump_col
    for seg_i, seg in enumerate(at.tables.segments):
        st = seg.stage
        for t in range(st.act.shape[0]):
            for r_i in np.nonzero(st.act[t])[0]:
                r = seg.rounds[r_i]
                rows = np.asarray(r.rows)
                slot = np.asarray(r.slot)
                if (rows[slot[t]] != dump).any():
                    return (seg_i, t, int(r_i))
    return None


def _tamper_drop_round_fire(at):
    site = _fire_site(at)
    if site is None:
        return at
    seg_i, t, r_i = site
    seg = at.tables.segments[seg_i]
    st = seg.stage
    act = np.array(st.act, copy=True)
    act[t, r_i] = False
    segs = list(at.tables.segments)
    segs[seg_i] = dataclasses.replace(
        seg, stage=dataclasses.replace(st, act=act)
    )
    at.tables.segments = tuple(segs)
    return at


def _table_mutation(cls, tamper, probe, detail, min_depth):
    def build(plan, dag, model, rng):
        from repro_torch.codegen.executor import segment_access_tables

        at = segment_access_tables(
            plan, model, buffer_depth=max(min_depth, 1), checkpoint=True,
        )
        if probe(at) is None:
            return None
        return Mutation(cls, detail, plan, tamper=tamper,
                        min_depth=min_depth)
    return build


_BUILDERS = {
    "drop_comm_round": _drop_comm_round,
    "drop_transfer": _drop_transfer,
    "merge_steps": _merge_steps,
    "misroute_transfer": _misroute_transfer,
    "double_deliver": _double_deliver,
    "alias_registers": _alias_registers,
    "swap_frame_parity": _table_mutation(
        "swap_frame_parity", _tamper_swap_frame_parity, _swap_parity_site,
        "landings of rotating frames 0 and 1 exchanged", 2,
    ),
    "shrink_retire_window": _table_mutation(
        "shrink_retire_window", _tamper_shrink_retire_window,
        _retire_window_site,
        "a frame-eviction retire copy delayed one tick past the reuse "
        "landing", 2,
    ),
    "mispad_cohort": _table_mutation(
        "mispad_cohort", _tamper_mispad_cohort, _mispad_site,
        "first real lane of a cohort row replaced by padding", 1,
    ),
    "drop_round_fire": _table_mutation(
        "drop_round_fire", _tamper_drop_round_fire, _fire_site,
        "one active (tick, round) landing suppressed", 1,
    ),
}


def mutate(cls: str, plan: ExecutionPlan, dag, model,
           seed: int = 0) -> Optional[Mutation]:
    """Build one seeded mutation of ``cls`` for this plan, or ``None``
    when the plan can't express the bug (e.g. frame classes at depth 1
    scope, a plan with no consumed transfers)."""
    rng = np.random.default_rng(seed)
    return _BUILDERS[cls](plan, dag, model, rng)
