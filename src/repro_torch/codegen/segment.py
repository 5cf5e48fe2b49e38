"""Structural compute signatures + kernel table for the segmented executor.

The unrolled MPMD executor traces ``apply_layer`` once per (node, superstep)
occurrence, so sliced plans' trace time grows with the task count.  The
segmented executor instead dispatches every tick through **one**
``lax.switch`` over a table of *kernels*, each traced once per segment — so
two tasks that are structurally identical (same op, same pads/stride, same
operand block shapes) share a single branch, and everything that
distinguishes them travels as data:

* **input assembly becomes gather rows**: a task's input block — the nested
  tiling reassembly of producer tiles, each leaf cropped to its window,
  concatenated per the layout tree, *and* pre-sliced by the op's static
  window (a ``conv_slice``'s halo rows, a ``pool_slice``'s channel range,
  an attention head's feature columns, a ``concat``'s channel interleave) —
  is precomputed host-side as a flat row of packed-buffer element positions
  (:func:`node_gather_rows`).  The branch does one ``take`` per logical
  slot, whatever the tile geometry, so interior and boundary tiles, 1-D and
  grid tilings, seen-through concats and glue all share kernels;
* **register identities** become buffer offsets in those rows;
* **parameter values** become stacked operand arrays, pre-sliced host-side
  (numpy) exactly the way ``apply_layer`` slices them in-trace (e.g. a
  ``conv_slice``'s ``w[..., c_lo:c_hi]`` column block), so the kernel math
  is bit-identical to the unrolled path.

:func:`node_signature` abstracts a :class:`LayerSpec` into ``(sig, pkey)``:
``sig = (op_sig, slot_shapes)`` is the hashable structural signature (a full
``conv`` and a ``conv_slice`` tile with the same geometry collapse onto the
same kernel), ``pkey`` names the parameter slice the kernel needs.

The host-side tables (signatures, gather rows, parameter slices, span
coalescing) are copied from the reference, so that ``validate_plan`` and
the analyzer check the same segment schema the executor runs.
:func:`make_kernel` builds the kernel for a signature — a mirror of the
port's own ``apply_layer`` arm (NHWC via permute, cuDNN convolutions and
pooling, cuBLAS products) with static attrs baked from the signature and
params taken as operands (:func:`param_operands`, the torch counterpart of
:func:`param_slices`).  Row pads arrive gathered from the sentinel columns,
so a kernel pads only W.  The reference's im2col branch for table-indexed
weights (a workaround for XLA:CPU's dynamic-filter convolution) has no
counterpart here: every weight is a tensor either way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.cnn import (
    CNNModel,
    _affine,
    _conv_relu,
    _pool_window,
    _row_window,
    _same_pads,
)

__all__ = [
    "node_signature",
    "node_gather_rows",
    "param_slices",
    "param_operands",
    "make_kernel",
    "SpanTable",
    "coalesce_spans",
    "resolve_rows",
    "max_sentinel_runs",
]

Sig = Tuple  # (op_sig, slot_shapes), nested hashable tuples
PKey = Optional[Tuple]

# gather-row sentinels for virtualized SAME row padding: the executor maps
# them to pristine buffer columns holding 0.0 / -inf respectively, so a
# boundary tile's halo pad is *gathered* instead of being a conv/pool pad
# attribute (which would split interior and boundary tiles into different
# signatures).  -inf is the maxpool identity; zero is exact for conv and
# avgpool (SAME-pad zeros contribute nothing to the sum, and apply_layer
# divides by k*k unconditionally).
ZERO_PAD = -1
NEGINF_PAD = -2


def _node_lowering(
    model: CNNModel, name: str, offsets: Optional[Mapping[str, int]]
):
    """Shared signature/gather-row derivation (one code path so the two can
    never disagree).  With ``offsets`` returns per-slot position blocks."""
    spec = model.spec(name)
    a = dict(spec.attrs)
    parents = spec.inputs
    pshapes = [tuple(model.spec(p).out_shape) for p in parents]
    layout = a.get("in_layout")
    boxes = a.get("in_boxes", (None,) * len(parents))

    def leaf_block(i: int, crop) -> Optional[np.ndarray]:
        """Buffer positions of one producer tile, cropped to its window."""
        if offsets is None:
            return None
        shp = pshapes[i]
        size = int(np.prod(shp)) if shp else 1
        blk = np.arange(size, dtype=np.int64).reshape(shp) + offsets[parents[i]]
        if crop is not None:
            blk = blk[tuple(slice(lo, hi) for (lo, hi) in crop)]
        return blk

    # mirror _assemble_inputs: per-slot assembled blocks (shapes always;
    # position arrays when offsets given) + per-slot (row, last-axis) bases
    slot_blocks: List[Optional[np.ndarray]] = []
    slot_shapes: List[Tuple[int, ...]] = []
    offs: List[Tuple[int, int]] = []
    if layout is None:
        for i in range(len(parents)):
            slot_blocks.append(leaf_block(i, None))
            slot_shapes.append(pshapes[i])
            offs.append((0, 0))
    else:
        i = 0

        def walk(tree) -> Tuple[Tuple[int, ...], Optional[np.ndarray]]:
            nonlocal i
            if tree is None:
                crop = boxes[i]
                shp = pshapes[i]
                if crop is not None:
                    shp = tuple(
                        hi - lo for (lo, hi) in crop
                    ) + tuple(shp[len(crop):])
                blk = leaf_block(i, crop)
                i += 1
                return tuple(shp), blk
            axis, kids = tree
            parts = [walk(k) for k in kids]
            shp = list(parts[0][0])
            shp[axis] = sum(p[0][axis] for p in parts)
            blk = None
            if offsets is not None:
                blk = np.concatenate([p[1] for p in parts], axis=axis)
            return tuple(shp), blk

        for ent in layout:
            if ent is None:
                slot_blocks.append(leaf_block(i, None))
                slot_shapes.append(pshapes[i])
                offs.append((0, 0))
                i += 1
            else:
                base, tree = ent
                shp, blk = walk(tree)
                slot_blocks.append(blk)
                slot_shapes.append(shp)
                offs.append(
                    (int(base[0]) if len(base) > 1 else 0, int(base[-1]))
                )

    def pre_slice(j: int, axis_windows: Mapping[int, Tuple[int, int]]) -> None:
        """Fold an op's static input window into slot ``j``'s block:
        ``axis_windows`` maps a (possibly negative) axis to its ``(lo, hi)``
        range.  Shapes update always; position blocks only when built."""
        shp = list(slot_shapes[j])
        nd = len(shp)
        idx = [slice(None)] * nd
        for ax, (lo, hi) in axis_windows.items():
            d = ax % nd
            idx[d] = slice(int(lo), int(hi))
            shp[d] = int(hi) - int(lo)
        slot_shapes[j] = tuple(shp)
        if slot_blocks[j] is not None:
            slot_blocks[j] = slot_blocks[j][tuple(idx)]

    op = spec.op
    pkey: PKey = None
    if op == "input":
        op_sig: Tuple = ("input",)
    elif op in ("output", "tile_concat", "reshape", "split"):
        if op == "split":
            lo, hi = a["channels"]
            pre_slice(0, {-1: (lo, hi)})
        op_sig = ("identity",)
    elif op == "concat":
        # fold the channel concat into one gathered slot
        shp = list(slot_shapes[0])
        shp[-1] = sum(s[-1] for s in slot_shapes)
        if offsets is not None:
            slot_blocks[:] = [np.concatenate(slot_blocks, axis=-1)]
        else:
            slot_blocks[:] = [None]
        slot_shapes[:] = [tuple(shp)]
        op_sig = ("identity",)
    elif op == "add":
        op_sig = ("add",)
    def virtual_rows(j: int, plo: int, phi: int, sentinel: int) -> None:
        """Materialize a slice op's SAME row padding as *gathered* sentinel
        rows instead of conv/reduce_window pad attributes.  The executor
        resolves ``ZERO_PAD``/``NEGINF_PAD`` to pristine buffer columns, so
        padded values are bit-identical to explicit pads — and interior and
        boundary tiles of one tiling collapse onto one signature (uniform
        row count, pads always ``(0, 0)``)."""
        if plo == 0 and phi == 0:
            return
        shp = list(slot_shapes[j])
        shp[0] += plo + phi
        slot_shapes[j] = tuple(shp)
        if slot_blocks[j] is not None:
            pad = [(0, 0)] * slot_blocks[j].ndim
            pad[0] = (plo, phi)
            slot_blocks[j] = np.pad(
                slot_blocks[j], pad, constant_values=sentinel
            )

    if op in ("input", "output", "tile_concat", "reshape", "split", "concat",
              "add"):
        pass  # op_sig set by the chain above
    elif op in ("conv", "conv_slice"):
        if op == "conv":
            h, w, cin = a["in_shape"]
            k, s = a["kernel"], a.get("stride", 1)
            plo, phi, _ = _same_pads(h, k, s)
            wshape = (k, k, cin, a["features"])
            pkey = ("full", name)
        else:
            h, w, cin = a["in_shape"]
            k, s = a["kernel"], a.get("stride", 1)
            ra, rb, plo, phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
            r0 = ra - offs[0][0]
            pre_slice(0, {0: (r0, r0 + (rb - ra))})
            wshape = (k, k, cin, a["c_hi"] - a["c_lo"])
            pkey = ("wcols", a["origin"], int(a["c_lo"]), int(a["c_hi"]))
        virtual_rows(0, int(plo), int(phi), ZERO_PAD)
        wl, wr, _ = _same_pads(w, k, s)
        op_sig = ("conv", int(s), (int(wl), int(wr)), wshape)
    elif op in ("maxpool", "avgpool", "pool_slice"):
        if op == "pool_slice":
            h, w, _c = a["in_shape"]
            k, s = a.get("kernel", 2), a.get("stride", 2)
            ra, rb, plo, phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
            r_off, c_off = offs[0]
            r0, c0 = ra - r_off, a["c_lo"] - c_off
            pre_slice(0, {0: (r0, r0 + (rb - ra)),
                          2: (c0, c0 + (a["c_hi"] - a["c_lo"]))})
            pool = a["pool"]
        else:
            h, w, _c = a["in_shape"]
            k, s = a.get("kernel", 2), a.get("stride", 2)
            plo, phi, _ = _same_pads(h, k, s)
            pool = op
        virtual_rows(
            0, int(plo), int(phi),
            NEGINF_PAD if pool == "maxpool" else ZERO_PAD,
        )
        wl, wr, _ = _same_pads(w, k, s)
        op_sig = ("pool", pool, int(k), int(s), (int(wl), int(wr)))
    elif op in ("dense", "dense_slice"):
        if op == "dense":
            wshape = (a["in_features"], a["features"])
            pkey = ("full", name)
        else:
            wshape = (a["in_features"], a["f_hi"] - a["f_lo"])
            pkey = ("dcols", a["origin"], int(a["f_lo"]), int(a["f_hi"]))
        op_sig = ("dense", bool(a.get("relu", True)), wshape)
    elif op in ("attn", "attn_slice"):
        hd = a["head_dim"]
        h_lo, h_hi = (
            (a["h_lo"], a["h_hi"]) if op == "attn_slice"
            else (0, a["n_heads"])
        )
        nh = h_hi - h_lo
        for j in range(3):
            c = h_lo * hd - offs[j][1]
            pre_slice(j, {-1: (c, c + nh * hd)})
        op_sig = ("attn", int(hd), int(nh))
    else:
        raise ValueError(f"unsupported op for segmented execution: {op}")

    sig = (op_sig, tuple(tuple(s) for s in slot_shapes))
    return sig, pkey, slot_blocks


def node_signature(model: CNNModel, name: str) -> Tuple[Sig, PKey]:
    """Structural signature + parameter-slice key of one plan node.

    Two nodes with equal signatures produce byte-identical traces through
    :func:`make_kernel`; everything else about them (which buffer elements
    they read, where they write, which parameter block they apply) is
    operand data."""
    sig, pkey, _blocks = _node_lowering(model, name, None)
    return sig, pkey


def node_gather_rows(
    model: CNNModel, name: str, offsets: Mapping[str, int]
) -> List[np.ndarray]:
    """Per-slot flattened packed-buffer positions of the node's (assembled,
    op-pre-sliced) input blocks — the executor's gather index rows."""
    _sig, _pkey, blocks = _node_lowering(model, name, offsets)
    return [b.reshape(-1) for b in blocks]


def param_slices(
    model: CNNModel, params: Mapping, pkey: PKey
) -> Tuple[np.ndarray, ...]:
    """Concrete parameter operands for one occurrence — sliced host-side
    (numpy, so table construction costs no device dispatches) exactly like
    the matching ``apply_layer`` arm slices them in-trace."""
    if pkey is None:
        return ()
    kind = pkey[0]
    if kind == "full":
        p = params[pkey[1]]
        return (np.asarray(p["w"]), np.asarray(p["b"]))
    if kind == "wcols":
        _k, origin, lo, hi = pkey
        p = params[origin]
        return (np.asarray(p["w"])[..., lo:hi], np.asarray(p["b"])[lo:hi])
    if kind == "dcols":
        _k, origin, lo, hi = pkey
        p = params[origin]
        return (np.asarray(p["w"])[:, lo:hi], np.asarray(p["b"])[lo:hi])
    raise ValueError(pkey)


def param_operands(
    params: Mapping, pkey: PKey
) -> Tuple[torch.Tensor, ...]:
    """:func:`param_slices` on the port's tensors: the same blocks, sliced
    on the parameters' device and made contiguous (so that every occurrence
    of one block hands its kernel the same memory layout)."""
    if pkey is None:
        return ()
    kind = pkey[0]
    if kind == "full":
        p = params[pkey[1]]
        w, b = p["w"], p["b"]
    elif kind == "wcols":
        _k, origin, lo, hi = pkey
        p = params[origin]
        w, b = p["w"][..., lo:hi], p["b"][lo:hi]
    elif kind == "dcols":
        _k, origin, lo, hi = pkey
        p = params[origin]
        w, b = p["w"][:, lo:hi], p["b"][lo:hi]
    else:
        raise ValueError(pkey)
    return (w.contiguous(), b.contiguous())


def make_kernel(sig: Sig) -> Callable:
    """Kernel for one signature: ``kernel(x, ins, pops) -> out``.

    ``ins`` are the gathered input blocks (already shaped per ``sig[1]``,
    batched), ``pops`` the parameter operands from :func:`param_operands`.
    The math mirrors the matching ``apply_layer`` arm of the port, with
    every static input window, and the row pads, already folded into the
    gather rows: a convolution or pooling kernel pads W only."""
    op_sig, _slot_shapes = sig
    kind = op_sig[0]

    if kind == "input":
        return lambda x, ins, pops: x
    if kind == "identity":
        return lambda x, ins, pops: ins[0]
    if kind == "add":
        return lambda x, ins, pops: ins[0] + ins[1]
    if kind == "conv":
        _k, s, wpads, _wsh = op_sig

        def kern(x, ins, pops):
            w_, b_ = pops
            return _conv_relu(ins[0], w_, b_, s, (0, 0), wpads)
        return kern
    if kind == "pool":
        _k, pool, k, s, wpads = op_sig
        return lambda x, ins, pops: _pool_window(ins[0], pool, k, s, (0, 0), wpads)
    if kind == "dense":
        _k, relu, _wsh = op_sig

        def kern(x, ins, pops):
            w_, b_ = pops
            return _affine(ins[0], w_, b_, relu)
        return kern
    if kind == "attn":
        _k, hd, nh = op_sig

        def kern(x, ins, pops):
            q, k_, v = ins
            b_, s_ = q.shape[0], q.shape[1]

            def heads(t: torch.Tensor) -> torch.Tensor:
                return t.reshape(b_, s_, nh, hd)

            scores = torch.einsum("bqhd,bkhd->bhqk", heads(q), heads(k_)) / math.sqrt(hd)
            probs = torch.softmax(scores, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", probs, heads(v))
            return o.reshape(b_, s_, nh * hd)
        return kern
    raise ValueError(kind)


# --------------------------------------------------------------------------- #
# span coalescing: gather rows -> contiguous dynamic_slice spans
# --------------------------------------------------------------------------- #
# A gathered slot is usually *piecewise* contiguous: a conv tile's rows are
# contiguous runs of the producer register broken only at row boundaries and
# halo pads, a seen-through concat interleaves contiguous channel blocks.
# Emitting one element ``lax.gather`` per slot makes XLA:CPU copy those runs
# element by element; cutting each row at the union of its occurrences'
# discontinuities instead yields a *static* piece structure shared by every
# occurrence of the signature, where each long piece is one memcpy-width
# ``dynamic_slice`` from a starts table.  Sentinel (halo-pad) entries resolve
# to ascending positions inside pristine sentinel *regions* (see
# :func:`resolve_rows`), so boundary tiles stay piecewise contiguous too and
# keep sharing the interior tiles' span structure.

# pieces at least this long become dynamic_slice spans; shorter pieces merge
# into element-gather remainder chunks.  Every span lowers to one
# dynamic_slice per signature branch, so the thresholds trade assembly
# coverage against traced-program size: (4, 192) puts ~96% of a grid-sliced
# inception plan's assembly on the memcpy path but multiplies segmented
# *trace* time ~4x (thousands of slice ops), while the defaults keep the
# long halo-row runs — the bulk of the moved bytes — and leave the fine
# channel interleaves of seen-through concats (whose break union shatters
# rows into short pieces) on the single element gather.  Measured runtime
# is flat across the range on serialized 1-core CI hosts; re-sweep on real
# multi-core targets before tightening further.
MIN_SPAN = 16
# fall back to one whole-slot element gather past this many span pieces
# (a long interleave is better served by one gather than by dozens of
# dynamic_slice + concatenate ops)
MAX_SPANS = 32
# ... or when spans would cover less than this fraction of the slot
MIN_COVERAGE = 0.4


@dataclasses.dataclass(frozen=True)
class SpanTable:
    """Static piece decomposition of one signature slot's gather rows.

    ``lens``/``kinds`` describe the pieces in row order (shared by every
    occurrence): a ``"span"`` piece of length ``lens[i]`` is assembled by one
    ``dynamic_slice`` starting at the occurrence's next ``starts`` column; a
    ``"rem"`` piece comes from the occurrence's next ``rem`` element-gather
    columns.  ``coverage`` is the fraction of slot elements served by spans.
    """

    lens: Tuple[int, ...]
    kinds: Tuple[str, ...]
    starts: np.ndarray   # (n_occ, n_span) int32 span start positions
    rem: np.ndarray      # (n_occ, n_rem_elements) int32 scattered positions
    coverage: float


def _max_run(mask: np.ndarray) -> int:
    """Longest run of True along the last axis of a boolean array."""
    if not mask.any():
        return 0
    m = mask.astype(np.int64)
    c = np.cumsum(m, axis=-1)
    reset = np.maximum.accumulate(np.where(m == 0, c, 0), axis=-1)
    return int(((c - reset) * m).max())


def max_sentinel_runs(row: np.ndarray) -> Tuple[int, int]:
    """Longest consecutive ``ZERO_PAD`` / ``NEGINF_PAD`` runs of a raw row —
    sizes the executor's sentinel regions so every pad run can resolve to a
    contiguous ascending range (and hence join a span)."""
    return _max_run(row == ZERO_PAD), _max_run(row == NEGINF_PAD)


def resolve_rows(
    raw: np.ndarray, zero_base: int, neginf_base: int
) -> np.ndarray:
    """Map sentinel entries of raw gather rows to buffer positions.

    Each maximal run of ``ZERO_PAD`` (``NEGINF_PAD``) becomes the ascending
    range ``[base, base + run_len)`` inside the zero (-inf) region, so a halo
    pad gathers a *contiguous* stretch of pristine sentinel columns instead
    of one repeated column — boundary tiles stay piecewise contiguous and
    coalesce into the same spans as interior tiles.  The caller guarantees
    the regions are at least as long as the longest run
    (:func:`max_sentinel_runs`)."""
    raw = np.atleast_2d(raw)
    out = raw.astype(np.int64).copy()
    idx = np.arange(raw.shape[1], dtype=np.int64)
    for sent, base in ((ZERO_PAD, zero_base), (NEGINF_PAD, neginf_base)):
        msk = raw == sent
        if not msk.any():
            continue
        first = msk.copy()
        first[:, 1:] &= ~msk[:, :-1]
        run_start = np.maximum.accumulate(
            np.where(first, idx[None, :], -1), axis=1
        )
        out[msk] = base + (idx[None, :] - run_start)[msk]
    return out.astype(np.int32)


def coalesce_spans(
    rows: np.ndarray,
    min_span: int = MIN_SPAN,
    max_spans: int = MAX_SPANS,
    min_coverage: float = MIN_COVERAGE,
) -> Optional[SpanTable]:
    """Cut resolved gather rows ``(n_occ, L)`` into maximal contiguous spans.

    Pieces are delimited by the union of every occurrence's discontinuities,
    so the piece structure is static per signature and every occurrence is
    contiguous inside every piece.  Pieces of at least ``min_span`` elements
    (or a piece covering the whole row) become ``dynamic_slice`` spans;
    adjacent shorter pieces merge into element-gather remainder chunks.
    Returns ``None`` — keep the whole-slot element gather — when there are
    no spans, too many (``max_spans``), or they cover less than
    ``min_coverage`` of the slot."""
    n_occ, L = rows.shape
    if L == 0 or n_occ == 0:
        return None
    brk = (np.diff(rows.astype(np.int64), axis=1) != 1).any(axis=0)
    bounds = np.concatenate(([0], np.nonzero(brk)[0] + 1, [L]))
    lens: List[int] = []
    kinds: List[str] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo >= min_span or hi - lo == L:
            lens.append(int(hi - lo))
            kinds.append("span")
        elif kinds and kinds[-1] == "rem":
            lens[-1] += int(hi - lo)
        else:
            lens.append(int(hi - lo))
            kinds.append("rem")
    n_span = kinds.count("span")
    if n_span == 0 or n_span > max_spans:
        return None
    coverage = sum(l for l, k in zip(lens, kinds) if k == "span") / L
    if coverage < min_coverage:
        return None
    starts: List[np.ndarray] = []
    rems: List[np.ndarray] = []
    p = 0
    for ln, kind in zip(lens, kinds):
        if kind == "span":
            starts.append(rows[:, p])
        else:
            rems.append(rows[:, p:p + ln])
        p += ln
    return SpanTable(
        lens=tuple(lens),
        kinds=tuple(kinds),
        starts=np.stack(starts, axis=1).astype(np.int32),
        rem=(
            np.concatenate(rems, axis=1).astype(np.int32)
            if rems else np.zeros((n_occ, 0), np.int32)
        ),
        coverage=float(coverage),
    )
