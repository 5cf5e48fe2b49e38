"""Operator-granularity lowering: a nested tiling IR over layer-DAG models.

The paper schedules one task per network layer, capping parallelism at the
width of the layer DAG (its branchy LeNet exists to manufacture width).  This
module lowers a :class:`~repro.models.cnn.CNNModel` — CNNs and the
transformer-block layer DAG alike — into an operator-granularity model whose
tasks are rectangular *tiles* of each layer's output.

**The tiling IR.**  How a producer's output is partitioned is described by a
recursive :class:`Tiling` tree.  Each node partitions one per-sample axis
into contiguous intervals (``bounds``); each interval holds either a *leaf*
— the name of the slice task producing exactly that slab — or a nested
``Tiling`` that partitions the slab along another axis.  The shapes this
expresses:

* **1-D tilings** — a single level of leaves: conv/pool output-channel or
  output-row tiles, dense output-feature row blocks, attention head blocks
  (stored in feature units);
* **2-D (cout × rows) grids** — a row-axis root whose children are
  channel-axis tilings ("rows of channel blocks"): conv/pool layers whose
  1-D tiles still dominate the critical path split along both axes, every
  tile an output-rows × output-channels rectangle with an exact SAME-padding
  halo;
* **composed concat tilings** — a channel ``concat`` *seen through*: each
  branch contributes its own subtree (channel tilings splice into the root,
  row/grid tilings nest under the branch's channel interval, untiled
  branches become single pseudo-tiles), so spatial inception modules with
  row-tiled branches need no reassembly either.

Because every tile is an axis-aligned box and boxes are per-axis interval
tuples, the whole downstream pipeline is dimension-agnostic: slice costs
(:func:`repro.core.costmodel.conv2d_slice_cost`), edge pricing
(:func:`repro.core.costmodel.box_bytes`), plan transfer hulls and the MPMD
executor's windowed payloads all consume the same generalized boxes.

**Direct slice-to-slice dataflow** (``direct=True``, the default): a
consumer slice whose input window intersects only some producer tiles reads
*those tiles* through halo-aware edges carrying exactly the intersection
bytes.  Consumers record the wiring in two attrs:

* ``in_layout`` — per logical input slot, ``None`` (whole producer tensor,
  untouched semantics) or ``(base, tree)``: ``tree`` is a nested assembly —
  ``None`` consumes the next input tensor (a producer tile cropped by its
  ``in_boxes`` window), ``(axis, children)`` concatenates its children's
  blocks along per-sample ``axis``.  Cropping every leaf to the consumer's
  window makes the assembled block exactly that window — rectangular even
  when subtrees tile different axes — and ``base`` (the window's per-axis
  low corner) is what ops shift their static windows by.
* ``in_boxes`` — per flattened input, the tile-local window of the
  intersection of the consumer's input window with that tile (``None`` ->
  the whole tile).  :meth:`CNNModel.to_dag` prices edges from it and
  ``build_plan`` ships per-destination hulls of it.

The ``tile_concat`` glue node survives only as a boundary adapter where
tilings genuinely misalign (flatten/reshape joins, residual adds, the final
output); it reassembles through the same ``in_layout`` machinery, and glue
with no remaining consumer is pruned, so aligned chains carry **no** concat
on the critical path (ACETONE's Writing/Reading channels ship exactly the
bytes a consumer core needs, paper §5).  ``direct=False`` reproduces the
reassemble-everything lowering.

**Factors are a per-layer mapping** — the canonical interface, produced by
:func:`choose_slice_factors` (roofline-parity search over 1-D counts *and*
(cout_parts, row_parts) grids) or :func:`uniform_factors` (one count for
every sliceable layer, the successor of the removed global ``slice_factor``
knob).  Values: an ``int`` tiles channels/features/heads; a ``(cout_parts,
row_parts)`` pair tiles a conv/pool as a grid (``(1, n)`` is a pure row
tiling).  Layers absent from the mapping — or whose tiled dimension is too
small — pass through untouched, so an empty mapping is the identity.

Slice tasks reference the originating layer's parameters (``attrs
["origin"]``), so the original ``init_params`` tree is shared, and execution
through every driver (``run_sequential`` / plan interpreter / MPMD executor)
stays bit-exact vs. the unsliced model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.core.costmodel import TPU_V5E, HardwareSpec
from repro_torch.models.cnn import CNNModel, LayerSpec, _row_window, _same_pads

__all__ = [
    "GRID_CANDIDATES",
    "SLICEABLE_OPS",
    "Factor",
    "Tiling",
    "choose_slice_factors",
    "model_tilings",
    "search_slice_factors",
    "slice_model",
    "slicing_summary",
    "tile_bounds",
    "tiling_leaves",
    "uniform_factors",
]

SLICEABLE_OPS = ("conv", "maxpool", "avgpool", "dense", "attn")

# per-layer tile spec: n channel/feature/head tiles, or a
# (cout_parts, row_parts) grid for conv/pool layers
Factor = Union[int, Tuple[int, int]]
_WINDOW_OPS = ("conv", "maxpool", "avgpool")


def tile_bounds(dim: int, n: int) -> List[Tuple[int, int]]:
    """Split ``range(dim)`` into ``min(n, dim)`` contiguous non-empty tiles."""
    n = max(1, min(n, dim))
    out = []
    for i in range(n):
        lo, hi = i * dim // n, (i + 1) * dim // n
        if hi > lo:
            out.append((lo, hi))
    return out


@dataclasses.dataclass(frozen=True)
class Tiling:
    """One level of the nested tiling tree of a producer's output.

    ``axis`` is per-sample: ``0`` for output rows, ``-1`` for the last axis
    (channels / features; attention head blocks are stored in feature
    units).  ``bounds`` are sorted, contiguous intervals partitioning the
    ``dim``-long slab this level covers; ``children[i]`` is either a leaf —
    the name of the task producing slab ``[bounds[i][0], bounds[i][1])`` —
    or a nested ``Tiling`` partitioning that slab along another axis.
    Bounds are absolute producer coordinates: a root tiling's slab starts
    at 0 (bounds partition ``[0, dim)``), while a branch tiling composed
    under a channel concat is rebased by the branch offset (bounds
    partition ``[off, off + dim)`` — ``dim`` is always the slab *extent*,
    not its upper bound).  A leaf's box is its own interval on ``axis``
    plus every ancestor's interval on *its* axis, full extent elsewhere.
    An unsliced producer inside a seen-through ``concat`` appears as a
    single pseudo-leaf (its own layer name).
    """

    axis: int
    dim: int
    bounds: Tuple[Tuple[int, int], ...]
    children: Tuple[Union[str, "Tiling"], ...]

    def n_leaves(self) -> int:
        return sum(
            c.n_leaves() if isinstance(c, Tiling) else 1 for c in self.children
        )


Box = Tuple[Tuple[int, int], ...]


def _leaf_box(
    anc: Dict[int, Tuple[int, int]], ai: int, lo: int, hi: int,
    pshape: Tuple[int, ...],
) -> Box:
    """Producer-coordinate box of one leaf: its own interval on its level's
    axis, every ancestor level's interval on *that* level's axis, full
    extent elsewhere — the single geometric rule both the ground-truth
    enumeration (:func:`tiling_leaves`) and direct-edge selection
    (``_select_tiles``) build boxes from."""
    box = [anc.get(k, (0, pshape[k])) for k in range(len(pshape))]
    box[ai] = (lo, hi)
    return tuple(box)


def tiling_leaves(
    tiling: Tiling, pshape: Tuple[int, ...]
) -> List[Tuple[str, Box]]:
    """``(leaf name, box)`` of every tile, boxes in producer coordinates.

    The geometric ground truth of the IR: for a valid tiling the boxes
    exactly partition the producer tensor ``pshape``.
    """
    nd = len(pshape)
    out: List[Tuple[str, Box]] = []

    def rec(t: Tiling, anc: Dict[int, Tuple[int, int]]) -> None:
        ai = t.axis % nd
        for (lo, hi), ch in zip(t.bounds, t.children):
            if isinstance(ch, Tiling):
                rec(ch, {**anc, ai: (lo, hi)})
            else:
                out.append((ch, _leaf_box(anc, ai, lo, hi, pshape)))

    rec(tiling, {})
    return out


# --------------------------------------------------------------------------- #
# per-layer tilers
# --------------------------------------------------------------------------- #
def _grid_parts(factor: Factor, out_c: int, out_h: int) -> Tuple[int, int]:
    """Normalize a conv/pool factor spec to capped (cout_parts, row_parts)."""
    if isinstance(factor, int):
        pc, pr = factor, 1
    else:
        pc, pr = factor
    return max(1, min(int(pc), out_c)), max(1, min(int(pr), out_h))


def _slice_window_op(
    l: LayerSpec, pc: int, pr: int, op: str, k: int, s: int,
    extra: Dict[str, object], chan_tag: str,
) -> Tuple[Optional[List[LayerSpec]], Optional[Tiling]]:
    """Shared conv/pool tiler: channel tiles, halo-exact row tiles, or a
    (cout × rows) grid of both, as a one- or two-level :class:`Tiling`."""
    out_h, out_w, out_c = l.out_shape
    h = l.attrs["in_shape"][0]
    if _same_pads(h, k, s)[2] != out_h:
        return None, None  # builder shape inconsistent with SAME semantics
    base = dict(extra, in_shape=l.attrs["in_shape"], kernel=k, stride=s,
                origin=l.name)
    slices: List[LayerSpec] = []
    if pr == 1:  # channel tiles
        bounds = tuple(tile_bounds(out_c, pc))
        for i, (lo, hi) in enumerate(bounds):
            attrs = dict(base, c_lo=lo, c_hi=hi, r_lo=0, r_hi=out_h,
                         tile=(chan_tag, lo, hi))
            slices.append(LayerSpec(f"{l.name}@s{i}", op, l.inputs,
                                    (out_h, out_w, hi - lo), attrs))
        tiling = Tiling(-1, out_c, bounds, tuple(s_.name for s_ in slices))
    elif pc == 1:  # row tiles
        bounds = tuple(tile_bounds(out_h, pr))
        for i, (lo, hi) in enumerate(bounds):
            attrs = dict(base, c_lo=0, c_hi=out_c, r_lo=lo, r_hi=hi,
                         tile=("rows", lo, hi))
            slices.append(LayerSpec(f"{l.name}@s{i}", op, l.inputs,
                                    (hi - lo, out_w, out_c), attrs))
        tiling = Tiling(0, out_h, bounds, tuple(s_.name for s_ in slices))
    else:  # (cout × rows) grid: rows of channel blocks
        rbounds = tuple(tile_bounds(out_h, pr))
        cbounds = tuple(tile_bounds(out_c, pc))
        rows: List[Tiling] = []
        for ri, (rlo, rhi) in enumerate(rbounds):
            names: List[str] = []
            for ci, (clo, chi) in enumerate(cbounds):
                attrs = dict(base, c_lo=clo, c_hi=chi, r_lo=rlo, r_hi=rhi,
                             tile=("grid", (rlo, rhi), (clo, chi)))
                sspec = LayerSpec(f"{l.name}@s{ri}x{ci}", op, l.inputs,
                                  (rhi - rlo, out_w, chi - clo), attrs)
                slices.append(sspec)
                names.append(sspec.name)
            rows.append(Tiling(-1, out_c, cbounds, tuple(names)))
        tiling = Tiling(0, out_h, rbounds, tuple(rows))
    if len(slices) < 2:
        return None, None
    return slices, tiling


def _slice_dense(
    l: LayerSpec, factor: int
) -> Tuple[Optional[List[LayerSpec]], Optional[Tiling]]:
    a = dict(l.attrs)
    f = a["features"]
    bounds = tuple(tile_bounds(f, factor))
    slices: List[LayerSpec] = []
    for i, (lo, hi) in enumerate(bounds):
        attrs = {
            "in_features": a["in_features"], "relu": a.get("relu", True),
            "origin": l.name, "f_lo": lo, "f_hi": hi, "tile": ("fout", lo, hi),
        }
        out_shape = (*l.out_shape[:-1], hi - lo)
        slices.append(LayerSpec(f"{l.name}@s{i}", "dense_slice", l.inputs,
                                out_shape, attrs))
    if len(slices) < 2:
        return None, None
    return slices, Tiling(-1, f, bounds, tuple(s.name for s in slices))


def _slice_attn(
    l: LayerSpec, factor: int
) -> Tuple[Optional[List[LayerSpec]], Optional[Tiling]]:
    a = dict(l.attrs)
    n, hd = a["n_heads"], a["head_dim"]
    slices: List[LayerSpec] = []
    bounds: List[Tuple[int, int]] = []
    for i, (lo, hi) in enumerate(tile_bounds(n, factor)):
        attrs = {
            "n_heads": n, "head_dim": hd, "seq": a["seq"], "origin": l.name,
            "h_lo": lo, "h_hi": hi, "tile": ("heads", lo, hi),
        }
        out_shape = (*l.out_shape[:-1], (hi - lo) * hd)
        slices.append(LayerSpec(f"{l.name}@s{i}", "attn_slice", l.inputs,
                                out_shape, attrs))
        bounds.append((lo * hd, hi * hd))  # head blocks in feature units
    if len(slices) < 2:
        return None, None
    return slices, Tiling(-1, n * hd, tuple(bounds),
                          tuple(s.name for s in slices))


def _lower_layer(
    l: LayerSpec, factor: Optional[Factor], ops: frozenset
) -> Tuple[Optional[List[LayerSpec]], Optional[Tiling]]:
    """Tile one layer: ``(slices, tiling)`` or ``(None, None)`` to keep it
    whole."""
    if factor is None or l.op not in ops:
        return None, None
    if l.op in _WINDOW_OPS:
        out_h, _out_w, out_c = l.out_shape
        pc, pr = _grid_parts(factor, out_c, out_h)
        if pc * pr < 2:
            return None, None
        if l.op == "conv":
            return _slice_window_op(
                l, pc, pr, "conv_slice",
                l.attrs["kernel"], l.attrs.get("stride", 1), {}, "cout",
            )
        return _slice_window_op(
            l, pc, pr, "pool_slice",
            l.attrs.get("kernel", 2), l.attrs.get("stride", 2),
            {"pool": l.op}, "chan",
        )
    n = factor if isinstance(factor, int) else int(factor[0]) * int(factor[1])
    if n < 2:
        return None, None
    if l.op == "dense":
        return _slice_dense(l, n)
    if l.op == "attn":
        return _slice_attn(l, n)
    return None, None


# --------------------------------------------------------------------------- #
# direct edge inference over the tiling tree
# --------------------------------------------------------------------------- #
def _needed_box(l: LayerSpec, pshape: Tuple[int, ...]) -> Box:
    """Per-axis input ranges slice task ``l`` reads of a producer shaped
    ``pshape`` (per-sample).  Axes the op does not window are full."""
    box = [(0, d) for d in pshape]
    a = l.attrs
    if l.op in ("conv_slice", "pool_slice") and len(pshape) == 3:
        k = a["kernel"] if l.op == "conv_slice" else a.get("kernel", 2)
        s = a.get("stride", 1) if l.op == "conv_slice" else a.get("stride", 2)
        ra, rb, _, _ = _row_window(a["r_lo"], a["r_hi"], a["in_shape"][0], k, s)
        box[0] = (ra, rb)
        if l.op == "pool_slice":
            box[-1] = (a["c_lo"], a["c_hi"])  # pools preserve channels
    elif l.op == "attn_slice":
        hd = a["head_dim"]
        box[-1] = (a["h_lo"] * hd, a["h_hi"] * hd)  # head block = feature cols
    return tuple(box)


def _is_full(box: Box, shape: Tuple[int, ...]) -> bool:
    return all(lo == 0 and hi == d for (lo, hi), d in zip(box, shape))


def _select_tiles(
    tiling: Tiling, box: Box, pshape: Tuple[int, ...]
) -> Tuple[object, List[str], List[Optional[Box]]]:
    """The minimal leaf set covering ``box``, plus the assembly gluing it.

    Returns ``(tree, names, crops)``: ``tree`` is the nested ``in_layout``
    assembly (``None`` = consume one leaf, ``(axis, children)`` = concat),
    ``names`` the leaves in assembly (DFS) order, ``crops`` each leaf's
    ``box ∩ tile`` window in tile-local coordinates (``None`` = the whole
    tile).  Cropping every leaf to ``box`` on *every* axis makes the
    assembled block exactly ``box`` — rectangular even when subtrees tile
    different axes (a row-tiled branch next to channel tiles under a
    seen-through concat).
    """
    nd = len(pshape)
    names: List[str] = []
    crops: List[Optional[Box]] = []

    def rec(t: Tiling, anc: Dict[int, Tuple[int, int]]) -> object:
        ai = t.axis % nd
        q_lo, q_hi = box[ai]
        kids: List[object] = []
        for (lo, hi), ch in zip(t.bounds, t.children):
            if hi <= q_lo or lo >= q_hi:
                continue
            if isinstance(ch, Tiling):
                kids.append(rec(ch, {**anc, ai: (lo, hi)}))
            else:
                leaf = _leaf_box(anc, ai, lo, hi, pshape)
                crop = tuple(
                    (max(a, c) - c, min(b, d) - c)
                    for (a, b), (c, d) in zip(box, leaf)
                )
                full = all(
                    lo2 == 0 and hi2 == d - c
                    for (lo2, hi2), (c, d) in zip(crop, leaf)
                )
                names.append(ch)
                crops.append(None if full else crop)
                kids.append(None)
        return kids[0] if len(kids) == 1 else (t.axis, tuple(kids))

    tree = rec(tiling, {})
    return tree, names, crops


def _shift_chan(t: Tiling, off: int) -> Tiling:
    """Rebase every channel-axis level of ``t`` by ``off`` — composing a
    branch tiling under a channel concat moves its channel coordinates to
    the branch's interval of the concatenated output."""
    if off == 0:
        return t
    children = tuple(
        _shift_chan(c, off) if isinstance(c, Tiling) else c for c in t.children
    )
    if t.axis == -1:
        return Tiling(-1, t.dim,
                      tuple((lo + off, hi + off) for lo, hi in t.bounds),
                      children)
    return Tiling(t.axis, t.dim, t.bounds, children)


def _compose_concat_tiling(
    l: LayerSpec, tilings: Dict[str, Tiling], model: CNNModel
) -> None:
    """See through a channel ``concat``: compose its inputs' tilings —
    channel, row, or (cout × rows) grids alike — into one tiling of the
    concatenated output, so consumers read branch tiles directly and the
    concat node drops off the dataflow path.  Channel-axis branch tilings
    splice their cells into the root; row/grid tilings nest (rebased) under
    the branch's channel interval; untiled inputs become single
    pseudo-leaves."""
    if not any(p in tilings for p in l.inputs):
        return
    bounds: List[Tuple[int, int]] = []
    children: List[Union[str, Tiling]] = []
    off = 0
    for p in l.inputs:
        width = model.spec(p).out_shape[-1]
        t = tilings.get(p)
        if t is None:
            bounds.append((off, off + width))
            children.append(p)
        elif t.axis == -1:
            shifted = _shift_chan(t, off)
            bounds.extend(shifted.bounds)
            children.extend(shifted.children)
        else:
            bounds.append((off, off + width))
            children.append(_shift_chan(t, off))
        off += width
    tilings[l.name] = Tiling(axis=-1, dim=off, bounds=tuple(bounds),
                             children=tuple(children))


def _rewire_direct(
    layers: List[LayerSpec],
    tilings: Dict[str, Tiling],
    spec_of: Dict[str, LayerSpec],
) -> List[LayerSpec]:
    """Replace glue-mediated slice inputs with direct tile edges.

    Every slice task gains ``in_layout`` plus per-flattened-input
    ``in_boxes`` — the window of the (tile or whole-producer) register the
    consumer actually reads, ``None`` when it reads all of it.  Boxes of
    untiled producers (e.g. the network input feeding row slices) are
    recorded too, so transfers of *unsliced* values also ship only the
    consumed window.
    """
    out: List[LayerSpec] = []
    for l in layers:
        if not l.op.endswith("_slice"):
            out.append(l)
            continue
        new_inputs: List[str] = []
        layout: List[Optional[Tuple[Tuple[int, ...], object]]] = []
        in_boxes: List[Optional[Box]] = []
        for pname in l.inputs:
            pshape = spec_of[pname].out_shape
            box = _needed_box(l, pshape)
            tiling = tilings.get(pname)
            if tiling is None:
                new_inputs.append(pname)
                layout.append(None)
                in_boxes.append(None if _is_full(box, pshape) else box)
                continue
            tree, names, crops = _select_tiles(tiling, box, pshape)
            layout.append((tuple(lo for lo, _ in box), tree))
            new_inputs.extend(names)
            in_boxes.extend(crops)
        attrs = dict(l.attrs)
        attrs["in_layout"] = tuple(layout)
        attrs["in_boxes"] = tuple(in_boxes)
        out.append(LayerSpec(l.name, l.op, tuple(new_inputs), l.out_shape, attrs))
    return out


def _prune_dead(layers: List[LayerSpec]) -> List[LayerSpec]:
    """Drop nodes no longer reachable from the final layer (dead glue and
    seen-through concats)."""
    if not layers:
        return layers
    spec_of = {l.name: l for l in layers}
    keep = set()
    stack = [layers[-1].name]
    while stack:
        n = stack.pop()
        if n in keep:
            continue
        keep.add(n)
        stack.extend(spec_of[n].inputs)
    return [l for l in layers if l.name in keep]


def _glue_spec(l: LayerSpec, tiling: Tiling) -> LayerSpec:
    """Reassembly glue: the original layer name rebuilt from its tiles
    through the shared ``in_layout`` assembly (nested for grids), so
    misaligned consumers (reshape/add/output boundaries) — and
    ``run_sequential`` equivalence for them — are untouched."""
    box = tuple((0, d) for d in l.out_shape)
    tree, names, _crops = _select_tiles(tiling, box, l.out_shape)
    return LayerSpec(
        l.name, "tile_concat", tuple(names), l.out_shape,
        {"origin": l.name,
         "in_layout": ((tuple(0 for _ in l.out_shape), tree),)},
    )


def _tile_layers(
    model: CNNModel,
    per_layer: Mapping[str, Factor],
    opset: frozenset,
    see_through: bool,
) -> Tuple[Dict[str, List[LayerSpec]], Dict[str, Tiling]]:
    """The single lowering sweep shared by :func:`slice_model` and
    :func:`model_tilings`: per-layer slices + tilings, with channel concats
    composed into the tiling map when ``see_through`` (direct mode)."""
    lowered: Dict[str, List[LayerSpec]] = {}
    tilings: Dict[str, Tiling] = {}
    for l in model.layers:
        slices, tiling = _lower_layer(l, per_layer.get(l.name), opset)
        if slices:
            lowered[l.name] = slices
            tilings[l.name] = tiling
        elif see_through and l.op == "concat":
            _compose_concat_tiling(l, tilings, model)
    return lowered, tilings


def model_tilings(
    model: CNNModel,
    factors: Mapping[str, Factor],
    ops: Sequence[str] = SLICEABLE_OPS,
    direct: bool = True,
) -> Dict[str, Tiling]:
    """The :class:`Tiling` tree of every sliced layer — including, in
    ``direct`` mode, the composed tilings of seen-through channel concats.
    Exactly the IR :func:`slice_model` threads through direct-edge
    inference (both run the same lowering sweep); exposed for geometry
    tests and the ``--grid`` demo."""
    _lowered, tilings = _tile_layers(model, dict(factors), frozenset(ops),
                                     see_through=direct)
    return tilings


def slice_model(
    model: CNNModel,
    factors: Mapping[str, Factor],
    ops: Sequence[str] = SLICEABLE_OPS,
    direct: bool = True,
    tag: str = "auto",
) -> CNNModel:
    """Lower ``model`` to operator granularity.

    ``factors`` maps layer names to tile specs (module docstring): ``int``
    channel/feature/head tiles, ``(cout_parts, row_parts)`` conv/pool
    grids.  Layers absent from the mapping — or whose tiled dimension is
    too small, or whose op is not in ``ops`` — pass through untouched, so
    an empty mapping is the identity.  Build mappings with
    :func:`choose_slice_factors` or :func:`uniform_factors`.

    ``direct=True`` emits halo-aware slice-to-slice edges through the
    tiling IR and prunes glue off aligned paths (module docstring);
    ``direct=False`` reassembles every sliced layer through a
    ``tile_concat`` node.

    Returns a new :class:`CNNModel` named ``{model.name}@{tag}``,
    executable by every existing driver with the *original* model's
    parameter tree.
    """
    lowered, tilings = _tile_layers(model, dict(factors), frozenset(ops),
                                    see_through=direct)
    out: List[LayerSpec] = []
    for l in model.layers:
        slices = lowered.get(l.name)
        if not slices:
            out.append(l)
            continue
        out.extend(slices)
        out.append(_glue_spec(l, tilings[l.name]))
    if direct:
        spec_of = {l.name: l for l in model.layers}
        out = _prune_dead(_rewire_direct(out, tilings, spec_of))
    return CNNModel(f"{model.name}@{tag}", tuple(out))


# --------------------------------------------------------------------------- #
# cost-model-driven slice factors
# --------------------------------------------------------------------------- #
def uniform_factors(
    model: CNNModel,
    n: int,
    ops: Sequence[str] = SLICEABLE_OPS,
    spatial: bool = False,
) -> Dict[str, Factor]:
    """``n`` tiles for every sliceable layer — the old global
    ``slice_factor`` knob expressed in the canonical mapping interface.
    ``spatial=True`` makes conv/pool tiles output-row tiles (``(1, n)``
    grids) instead of channel tiles; layers with a single output row (e.g.
    a global avgpool) fall back to channel tiles so they still slice."""
    if n < 1:
        raise ValueError("tile count must be >= 1")
    opset = frozenset(ops)
    return {
        l.name: (
            (1, n)
            if spatial and l.op in _WINDOW_OPS and l.out_shape[0] > 1
            else n
        )
        for l in model.layers
        if l.op in opset
    }


def _tile_parity(
    slices: List[LayerSpec], hw: HardwareSpec, balance: float
) -> Tuple[bool, float]:
    """Does even the smallest tile's compute still dominate shipping the
    largest tile?  Returns ``(parity holds, largest-tile comm time)``."""
    t_tile = min(s.cost().time(hw) for s in slices)
    w_tile = max(hw.comm_time(s.out_bytes()) for s in slices)
    return t_tile >= balance * w_tile, w_tile


def _best_1d(
    l: LayerSpec, hw: HardwareSpec, max_factor: int, balance: float,
    opset: frozenset,
) -> Optional[int]:
    best = None
    for k in range(2, max_factor + 1):
        slices, _tiling = _lower_layer(l, k, opset)
        if not slices:
            break
        ok, _w = _tile_parity(slices, hw, balance)
        if ok:
            best = len(slices)
        else:
            break
        if len(slices) < k:  # capped by the tiled dim: higher k is identical
            break
    return best


def _best_grid(
    l: LayerSpec, hw: HardwareSpec, max_factor: int, balance: float,
    opset: frozenset,
) -> Optional[Factor]:
    """Search every (cout_parts, row_parts) grid with at most ``max_factor``
    tiles at roofline parity; keep the one with the most tiles (ties:
    cheapest largest-tile shipping, then the squarest grid)."""
    best: Optional[Tuple[int, int]] = None
    best_key = None
    out_h, _w, out_c = l.out_shape
    seen = set()  # capped duplicates lower identically — evaluate once
    for pc in range(1, max_factor + 1):
        for pr in range(1, max_factor // pc + 1):
            if pc * pr < 2:
                continue
            capped = _grid_parts((pc, pr), out_c, out_h)
            if capped in seen:
                continue
            seen.add(capped)
            slices, _tiling = _lower_layer(l, (pc, pr), opset)
            if not slices:
                continue
            ok, w_tile = _tile_parity(slices, hw, balance)
            if not ok:
                continue
            key = (len(slices), -w_tile, -abs(pc - pr))
            if best_key is None or key > best_key:
                best_key = key
                best = (pc, pr)
    if best is None:
        return None
    pc, pr = _grid_parts(best, out_c, out_h)
    return pc if pr == 1 else (pc, pr)


def choose_slice_factors(
    model: CNNModel,
    hw: HardwareSpec = TPU_V5E,
    max_factor: int = 16,
    balance: float = 1.0,
    ops: Sequence[str] = SLICEABLE_OPS,
    grid: bool = True,
) -> Dict[str, Factor]:
    """Per-layer tile specs from the roofline cost model.

    The parity rule, per candidate tiling: keep it while even the
    *smallest* tile's compute time still dominates the comm cost of
    shipping the *largest* tile (``t_tile >= balance * w_tile``) —
    splitting such a layer buys parallelism that outweighs the traffic it
    creates; beyond parity a tile is cheaper to recompute locally than to
    ship, so further slicing only inflates the schedule's comm load.

    Dense/attention layers (and conv/pool with ``grid=False``) grow a 1-D
    tile count until parity breaks.  Conv/pool layers with ``grid=True``
    (default) search *every* (cout_parts, row_parts) grid with at most
    ``max_factor`` tiles and keep the parity-satisfying candidate with the
    most tiles (ties: cheapest largest-tile shipping, then the squarest
    grid) — the big stem convs whose 1-D tiles exhaust one axis keep
    splitting along the other.  Pure channel grids are returned as plain
    ints; layers worth no split are omitted (identity under
    :func:`slice_model`).
    """
    opset = frozenset(ops)
    factors: Dict[str, Factor] = {}
    for l in model.layers:
        if l.op not in opset:
            continue
        if grid and l.op in _WINDOW_OPS:
            spec = _best_grid(l, hw, max_factor, balance, opset)
        else:
            spec = _best_1d(l, hw, max_factor, balance, opset)
        if spec is not None:
            factors[l.name] = spec
    return factors


# per-layer moves of the schedule-aware search: drop the layer, 1-D channel
# counts, and (cout_parts, row_parts) grids (pure-row grids included)
GRID_CANDIDATES: Tuple[Optional[Factor], ...] = (
    None, 2, 4, 8,
    (1, 2), (1, 4), (1, 8),
    (2, 2), (2, 4), (2, 8), (4, 2), (4, 4),
)


def search_slice_factors(
    model: CNNModel,
    hw: HardwareSpec = TPU_V5E,
    m: int = 8,
    heuristic=None,
    candidates: Sequence[Optional[Factor]] = GRID_CANDIDATES,
    seeds: Sequence[int] = (4, 8),
    rounds: int = 2,
    time_unit: float = 1e-9,
) -> Dict[str, Factor]:
    """Grid-aware slice-factor search against the *scheduled* makespan.

    :func:`choose_slice_factors`' parity rule prices each layer in
    isolation; it cannot see that splitting a stem conv along *both* axes
    shortens the critical path only when its consumers' tilings align, or
    that a fat bytes-bound edge is cheaper as two parallel half-windows.
    This search closes the loop through the scheduler itself: seed with the
    best uniform single-axis tiling (``seeds`` × channel/row), then
    coordinate-descend per layer — heaviest first — over ``candidates``
    (1-D counts and (cout_parts, row_parts) grids), keeping a move only if
    the ``heuristic``'s makespan on ``m`` workers improves.  Deterministic:
    same model/hardware/heuristic -> same mapping.

    Scheduling a few-hundred-task DAG takes milliseconds, so a full search
    is a few hundred schedules; pass ``rounds=1`` for a cheaper pass.  On
    TPU-priced inception (224) with 8 workers the result schedules >= 10%
    below the best uniform single-axis tiling (asserted in the benchmark's
    grid acceptance gate).
    """
    if heuristic is None:
        from repro_torch.core.list_scheduling import dsh as heuristic  # noqa: PLC0415

    memo: Dict[frozenset, float] = {}

    def evaluate(factors: Mapping[str, Factor]) -> float:
        # memoized across rounds: the convergence round re-visits every
        # candidate it already scheduled, so it becomes pure lookups
        key = frozenset(factors.items())
        mk = memo.get(key)
        if mk is None:
            sliced = slice_model(model, factors)
            sdag = sliced.to_dag(hw, time_unit=time_unit)
            mk = memo[key] = heuristic(sdag, m).makespan(sdag)
        return mk

    best_mk, best = min(
        (
            (evaluate(f), f)
            for n in seeds
            for f in (uniform_factors(model, n),
                      uniform_factors(model, n, spatial=True))
        ),
        key=lambda kv: kv[0],
    )
    cur = dict(best)
    opset = frozenset(SLICEABLE_OPS)
    order = sorted(
        (l for l in model.layers if l.op in opset),
        key=lambda l: -l.cost().time(hw),
    )

    def norm(l: LayerSpec, c: Optional[Factor]):
        """Per-layer canonical form of a candidate, so moves that lower
        identically (grids collapsing to their product on dense/attn, caps
        coinciding on small conv/pool layers) evaluate only once."""
        if c is None:
            return None
        if l.op in _WINDOW_OPS:
            pc, pr = _grid_parts(c, l.out_shape[-1], l.out_shape[0])
            return None if pc * pr < 2 else (pc, pr)
        n = c if isinstance(c, int) else int(c[0]) * int(c[1])
        return None if n < 2 else n

    for _ in range(max(1, rounds)):
        improved = False
        for l in order:
            base = cur.get(l.name)
            best_c, best_v = base, best_mk
            seen = {norm(l, base)}
            for c in candidates:
                key = norm(l, c)
                if key in seen:
                    continue
                seen.add(key)
                trial = dict(cur)
                if c is None:
                    trial.pop(l.name, None)
                else:
                    trial[l.name] = c
                v = evaluate(trial)
                if v < best_v - 1e-9:
                    best_v, best_c = v, c
            if best_c != base:
                if best_c is None:
                    cur.pop(l.name, None)
                else:
                    cur[l.name] = best_c
                best_mk = best_v
                improved = True
        if not improved:
            break
    return cur


def _n_tree_leaves(tree: object) -> int:
    if tree is None:
        return 1
    _axis, kids = tree
    return sum(_n_tree_leaves(k) for k in kids)


def slicing_summary(model: CNNModel, sliced: CNNModel) -> Dict[str, object]:
    """Small report for demos/benchmarks: task counts and tile stats."""
    origins: Dict[str, int] = {}
    glue = 0
    direct_edges = 0
    grid_layers = set()
    for l in sliced.layers:
        if l.op.endswith("_slice"):
            origins[str(l.attrs["origin"])] = origins.get(str(l.attrs["origin"]), 0) + 1
            if l.attrs.get("tile", (None,))[0] == "grid":
                grid_layers.add(str(l.attrs["origin"]))
            if "in_layout" in l.attrs:
                direct_edges += sum(
                    _n_tree_leaves(ent[1])
                    for ent in l.attrs["in_layout"]
                    if ent is not None
                )
        elif l.op == "tile_concat":
            glue += 1
    return {
        "layers": len(model.layers),
        "tasks": len(sliced.layers),
        "sliced_layers": len(origins),
        "slice_tasks": sum(origins.values()),
        "max_tiles": max(origins.values()) if origins else 0,
        "grid_layers": len(grid_layers),
        "glue_nodes": glue,
        "direct_edges": direct_edges,
    }
