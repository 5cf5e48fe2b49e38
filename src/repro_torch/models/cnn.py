"""ACETONE-style layer-DAG CNN models (paper §2.2, §5), in PyTorch.

Port of ``repro/models/cnn.py``.  The layer specs, their costs, ``to_dag``
and the four model builders are the reference's, copied; the op semantics
(``apply_layer``) compute through PyTorch: cuDNN convolutions and cuBLAS
products on the card.  Activations keep the reference's logical layout,
batched NHWC, and parameters its HWIO conv / ``[in, out]`` dense weights,
so transfer boxes, tile windows and weight slices index the same axes as
in the reference; tensors are viewed as NCHW/OIHW only around the
convolution and pooling calls.  SAME padding (asymmetric for stride 2) is
applied explicitly with ``F.pad``: zeros for convolutions and average
pooling (which then divides by k·k), −inf for max pooling.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.costmodel import (
    HardwareSpec,
    OpCost,
    TPU_V5E,
    attention_cost,
    box_bytes,
    conv2d_cost,
    conv2d_slice_cost,
    dense_cost,
    elementwise_cost,
    pool2d_cost,
    pool2d_slice_cost,
)
from repro_torch.core.graph import DAG
from repro_torch.device import DeviceLike, resolve_device

__all__ = [
    "LayerSpec",
    "CNNModel",
    "lenet5",
    "lenet5_branchy",
    "inception_net",
    "transformer_block",
    "apply_layer",
    "run_sequential",
]

Params = Mapping[str, Mapping[str, torch.Tensor]]


# --------------------------------------------------------------------------- #
# SAME-padding tile windows (shared by slice-op semantics and slice costs)
# --------------------------------------------------------------------------- #
def _same_pads(size: int, k: int, s: int) -> Tuple[int, int, int]:
    """XLA/TF ``SAME`` pads for one spatial dim: ``(pad_lo, pad_hi, out)``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    lo = total // 2
    return lo, total - lo, out


def _row_window(r_lo: int, r_hi: int, size: int, k: int, s: int) -> Tuple[int, int, int, int]:
    """Input-row window (with halo) computing output rows ``[r_lo, r_hi)``.

    Returns ``(a, b, pad_lo, pad_hi)``: read input rows ``[a, b)`` and pad
    them explicitly so a VALID window sweep reproduces exactly the SAME-padded
    layer's output rows ``[r_lo, r_hi)``.
    """
    pt, _pb, _out = _same_pads(size, k, s)
    lo = r_lo * s - pt
    hi = (r_hi - 1) * s + k - pt
    a, b = max(lo, 0), min(hi, size)
    return a, b, a - lo, hi - b


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One ACETONE layer: op + static attributes + parent layer names."""

    name: str
    op: str                      # input|conv|maxpool|avgpool|dense|concat|split|reshape|output
    inputs: Tuple[str, ...]
    out_shape: Tuple[int, ...]   # per-sample (no batch dim)
    attrs: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def cost(self) -> OpCost:
        a = dict(self.attrs)
        if self.op == "conv":
            h, w, cin = a["in_shape"]
            return conv2d_cost(h, w, cin, a["features"], a["kernel"], a["kernel"],
                               stride=a.get("stride", 1))
        if self.op in ("maxpool", "avgpool"):
            h, w, c = a["in_shape"]
            return pool2d_cost(h, w, c, a.get("kernel", 2), stride=a.get("stride", 2))
        if self.op == "dense":
            return dense_cost(a["in_features"], a["features"])
        if self.op == "conv_slice":
            h, w, cin = a["in_shape"]
            k, s = a["kernel"], a.get("stride", 1)
            ra, rb, _plo, _phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
            _wl, _wr, out_cols = _same_pads(w, k, s)
            return conv2d_slice_cost(
                rb - ra, w, cin, k, k,
                a["r_hi"] - a["r_lo"], out_cols, a["c_hi"] - a["c_lo"],
            )
        if self.op == "pool_slice":
            h, w, _c = a["in_shape"]
            k, s = a.get("kernel", 2), a.get("stride", 2)
            ra, rb, _plo, _phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
            _wl, _wr, out_cols = _same_pads(w, k, s)
            return pool2d_slice_cost(
                rb - ra, w, a["c_hi"] - a["c_lo"], k,
                a["r_hi"] - a["r_lo"], out_cols,
            )
        if self.op == "dense_slice":
            return dense_cost(a["in_features"], a["f_hi"] - a["f_lo"])
        if self.op in ("attn", "attn_slice"):
            n_heads = (
                a["h_hi"] - a["h_lo"] if self.op == "attn_slice" else a["n_heads"]
            )
            return attention_cost(a["seq"], a["head_dim"], n_heads)
        if self.op == "add":
            return elementwise_cost(int(np.prod(self.out_shape)), flops_per_elem=1.0)
        if self.op in ("concat", "split", "input", "output", "tile_concat"):
            n = int(np.prod(self.out_shape))
            return elementwise_cost(n, flops_per_elem=0.0)
        if self.op == "reshape":
            return OpCost(0.0, 0.0)  # paper Table 1: reshape WCET = 0
        raise ValueError(self.op)

    def out_bytes(self, dtype_bytes: int = 4) -> float:
        return float(np.prod(self.out_shape)) * dtype_bytes


@dataclasses.dataclass(frozen=True)
class CNNModel:
    name: str
    layers: Tuple[LayerSpec, ...]  # topological order

    def spec_map(self) -> Dict[str, LayerSpec]:
        """name -> spec, built once (executors look specs up per node per
        superstep; sliced models have hundreds of layers, so the linear scan
        this replaces was O(L^2) across a plan)."""
        cache = self.__dict__.get("_spec_map")
        if cache is None:
            cache = {l.name: l for l in self.layers}
            object.__setattr__(self, "_spec_map", cache)
        return cache

    def spec(self, name: str) -> LayerSpec:
        return self.spec_map()[name]

    # -------------------------------------------------------------- #
    def init_params(self, seed: int = 0, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> Dict[str, Dict[str, torch.Tensor]]:
        """Weights at the reference's scales (conv ``N(0, 1)/sqrt(k·k·cin)``,
        dense ``N(0, 1)/sqrt(in)``, zero biases), drawn from one
        ``torch.Generator`` seeded with ``seed``, in layer order.  They are
        not the reference's numbers (its keys fold in ``hash(name)``, which
        Python salts per process): tests hand the reference's weights over
        with ``repro_torch.convert.cnn_params_from_numpy``."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        params: Dict[str, Dict[str, torch.Tensor]] = {}
        for l in self.layers:
            a = l.attrs
            if l.op == "conv":
                cin = a["in_shape"][2]
                wshape = (a["kernel"], a["kernel"], cin, a["features"])
                fan_in = a["kernel"] * a["kernel"] * cin
            elif l.op == "dense":
                wshape = (a["in_features"], a["features"])
                fan_in = a["in_features"]
            else:
                continue
            w = torch.randn(wshape, generator=gen, dtype=torch.float32) / math.sqrt(fan_in)
            params[l.name] = {
                "w": w.to(device=dev, dtype=dtype),
                "b": torch.zeros((a["features"],), device=dev, dtype=dtype),
            }
        return params

    # -------------------------------------------------------------- #
    def to_dag(self, hw: HardwareSpec = TPU_V5E, time_unit: float = 1e-9) -> DAG:
        """Cost-annotated task DAG (t in ``time_unit`` seconds).

        Edge weights default to the *producer's* output bytes, so slice-task
        edges are priced at actual tile bytes; direct slice-to-slice edges
        carry ``attrs["in_boxes"]`` — the consumer-window ∩ producer-tile
        intersection — and are priced at exactly those bytes.  Boxes are
        per-axis interval tuples, so 1-D tiles and 2-D (cout × rows) grid
        tiles price identically.  Node metadata records each task's op,
        originating layer, tile coordinates and input boxes (``in_boxes``,
        parent-edge aligned), which ``build_plan`` uses to ship windowed
        transfer payloads.
        """
        t = {l.name: max(l.cost().time(hw) / time_unit, 1e-3) for l in self.layers}
        edges = []
        w = {}
        meta = {}
        for l in self.layers:
            m = {"op": l.op, "origin": l.attrs.get("origin", l.name)}
            if "tile" in l.attrs:
                m["tile"] = l.attrs["tile"]
            in_boxes = l.attrs.get("in_boxes")
            # a layer may read the same producer through several slots (a
            # residual add of one tensor, glue concatenating two windows of
            # one tile): the DAG carries one edge per distinct parent, so
            # duplicate slots collapse — their windows union (``None`` = a
            # whole-register read wins), and the edge is priced at the union
            ded: List[str] = []
            ded_idx: Dict[str, int] = {}
            ded_boxes: List[Optional[Tuple[Tuple[int, int], ...]]] = []
            for idx, p in enumerate(self.inputs_of(l.name)):
                box = in_boxes[idx] if in_boxes is not None else None
                if p in ded_idx:
                    j = ded_idx[p]
                    old = ded_boxes[j]
                    ded_boxes[j] = None if (old is None or box is None) else tuple(
                        (min(a, lo), max(b, hi))
                        for (a, b), (lo, hi) in zip(old, box)
                    )
                else:
                    ded_idx[p] = len(ded)
                    ded.append(p)
                    ded_boxes.append(box)
            if in_boxes is not None:
                m["in_boxes"] = tuple(ded_boxes)
            meta[l.name] = m
            for p, box in zip(ded, ded_boxes):
                e = (p, l.name)
                edges.append(e)
                b = box_bytes(box) if box is not None else self.spec(p).out_bytes()
                w[e] = hw.comm_time(b) / time_unit
        return DAG.build(
            nodes=tuple(l.name for l in self.layers), edges=tuple(edges), t=t, w=w,
            meta=meta,
        )

    def inputs_of(self, name: str) -> Tuple[str, ...]:
        return self.spec(name).inputs


# --------------------------------------------------------------------------- #
# op semantics (batched NHWC)
# --------------------------------------------------------------------------- #
def _assemble_inputs(
    layout, boxes, inputs: Sequence[torch.Tensor]
) -> Tuple[List[torch.Tensor], List[Tuple[int, int]]]:
    """Reassemble logical inputs from direct tile edges (nested tiling IR).

    ``layout`` (``attrs["in_layout"]``, from the slicer) maps each logical
    slot to either ``None`` — one input tensor, passed through whole — or
    ``(base, tree)``: ``tree`` is a nested assembly whose leaves (``None``)
    consume the next input tensor cropped to its ``boxes`` window
    (tile-local; ``None`` = the whole tile) and whose internal nodes
    ``(axis, children)`` concatenate child blocks along per-sample
    ``axis``.  Cropping every leaf makes the assembled block exactly the
    consumer's input window, whose per-axis low corner is ``base`` — rows
    of channel blocks for 2-D grids assemble the same way as 1-D tilings.
    Returns the logical tensors plus per-slot ``(row, last-axis)`` offsets
    so ops can shift their static windows into block coordinates.
    """
    vals: List[torch.Tensor] = []
    offs: List[Tuple[int, int]] = []
    i = 0

    def build(tree) -> torch.Tensor:
        nonlocal i
        if tree is None:  # leaf: one producer tile, cropped to its window
            x = inputs[i]
            crop = boxes[i]
            i += 1
            if crop is not None:
                x = x[(slice(None), *(slice(lo, hi) for (lo, hi) in crop))]
            return x
        axis, kids = tree
        parts = [build(k) for k in kids]
        bax = axis + 1 if axis >= 0 else axis  # per-sample -> batched axis
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=bax)

    for ent in layout:
        if ent is None:
            vals.append(inputs[i])
            offs.append((0, 0))
            i += 1
            continue
        base, tree = ent
        vals.append(build(tree))
        offs.append((base[0] if len(base) > 1 else 0, base[-1]))
    return vals, offs


def _slot_offsets(offs, slot: int) -> Tuple[int, int]:
    """(row offset, last-axis offset) of logical input ``slot``."""
    return offs[slot]


def _pad_hw(x: torch.Tensor, rows: Tuple[int, int], cols: Tuple[int, int],
            value: float = 0.0) -> torch.Tensor:
    """Pad an NHWC tensor's rows and columns explicitly (SAME pads may be
    asymmetric, which the NCHW calls' own ``padding`` cannot express)."""
    if rows == (0, 0) and cols == (0, 0):
        return x
    return F.pad(x, (0, 0, cols[0], cols[1], rows[0], rows[1]), value=value)


def _conv_relu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, s: int,
               rows: Tuple[int, int], cols: Tuple[int, int]) -> torch.Tensor:
    """relu(conv(x, w) + b) of NHWC ``x`` and HWIO ``w`` over the explicitly
    padded window (a VALID sweep at stride ``s``), NHWC out.  The NCHW view
    of an NHWC tensor is channels-last, which cuDNN takes as it is."""
    xp = _pad_hw(x, rows, cols).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w.permute(3, 2, 0, 1), b, stride=s)
    return torch.relu(y.permute(0, 2, 3, 1))


def _pool_window(x: torch.Tensor, kind: str, k: int, s: int,
          rows: Tuple[int, int], cols: Tuple[int, int]) -> torch.Tensor:
    """k×k pooling at stride ``s`` over the explicitly padded window:
    ``maxpool`` pads with −inf, ``avgpool`` sums zero pads and divides by
    k·k, as ``reduce_window`` does in the reference."""
    if kind == "maxpool":
        xp = _pad_hw(x, rows, cols, value=-math.inf).permute(0, 3, 1, 2)
        y = F.max_pool2d(xp, k, s)
    else:
        xp = _pad_hw(x, rows, cols).permute(0, 3, 1, 2)
        y = F.avg_pool2d(xp, k, s)
    return y.permute(0, 2, 3, 1)


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    y = x @ w + b
    return torch.relu(y) if relu else y


def apply_layer(
    spec: LayerSpec,
    params: Params,
    inputs: Sequence[torch.Tensor],
) -> torch.Tensor:
    a = dict(spec.attrs)
    if "in_layout" in a:
        boxes = a.get("in_boxes", (None,) * len(inputs))
        inputs, offs = _assemble_inputs(a["in_layout"], boxes, inputs)
    else:
        offs = [(0, 0)] * len(inputs)
    if spec.op == "input":
        (x,) = inputs
        return x
    if spec.op == "conv":
        (x,) = inputs
        k, s = a["kernel"], a.get("stride", 1)
        pt, pb, _ = _same_pads(x.shape[1], k, s)
        pl, pr, _ = _same_pads(x.shape[2], k, s)
        p = params[spec.name]
        return _conv_relu(x, p["w"], p["b"], s, (pt, pb), (pl, pr))
    if spec.op in ("maxpool", "avgpool"):
        (x,) = inputs
        k = a.get("kernel", 2)
        s = a.get("stride", 2)
        pt, pb, _ = _same_pads(x.shape[1], k, s)
        pl, pr, _ = _same_pads(x.shape[2], k, s)
        return _pool_window(x, spec.op, k, s, (pt, pb), (pl, pr))
    if spec.op == "dense":
        (x,) = inputs
        p = params[spec.name]
        return _affine(x, p["w"], p["b"], a.get("relu", True))
    if spec.op == "conv_slice":
        # one tile of a conv layer: output rows [r_lo, r_hi) x output
        # channels [c_lo, c_hi), reading the halo'd input row window and the
        # originating layer's weight slice (bit-exact vs. conv + slicing).
        # Under direct tile edges the input block may start at a row offset
        # (subset of a row-tiled producer); the static window shifts with it.
        (x,) = inputs
        r_off, _ = _slot_offsets(offs, 0)
        h, w, _cin = a["in_shape"]
        k, s = a["kernel"], a.get("stride", 1)
        ra, rb, plo, phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
        wl, wr, _ = _same_pads(w, k, s)
        p = params[a["origin"]]
        return _conv_relu(x[:, ra - r_off:rb - r_off], p["w"][..., a["c_lo"]:a["c_hi"]],
                          p["b"][a["c_lo"]:a["c_hi"]], s, (plo, phi), (wl, wr))
    if spec.op == "pool_slice":
        (x,) = inputs
        r_off, c_off = _slot_offsets(offs, 0)
        h, w, _c = a["in_shape"]
        k, s = a.get("kernel", 2), a.get("stride", 2)
        ra, rb, plo, phi = _row_window(a["r_lo"], a["r_hi"], h, k, s)
        wl, wr, _ = _same_pads(w, k, s)
        xs = x[:, ra - r_off:rb - r_off, :, a["c_lo"] - c_off:a["c_hi"] - c_off]
        return _pool_window(xs, a["pool"], k, s, (plo, phi), (wl, wr))
    if spec.op == "dense_slice":
        (x,) = inputs
        p = params[a["origin"]]
        return _affine(x, p["w"][:, a["f_lo"]:a["f_hi"]], p["b"][a["f_lo"]:a["f_hi"]],
                      a.get("relu", True))
    if spec.op in ("attn", "attn_slice"):
        q, k, v = inputs
        hd, n_heads = a["head_dim"], a["n_heads"]
        h_lo, h_hi = (
            (a["h_lo"], a["h_hi"]) if spec.op == "attn_slice" else (0, n_heads)
        )
        b_, s_ = q.shape[0], q.shape[1]

        def heads(t: torch.Tensor, slot: int) -> torch.Tensor:
            # a head block is a contiguous feature column range; with direct
            # tile edges the projection arrives as a sub-block starting at a
            # feature offset, so window first, then fold into heads
            _, f_off = _slot_offsets(offs, slot)
            cols = t[..., h_lo * hd - f_off:h_hi * hd - f_off]
            return cols.reshape(b_, s_, h_hi - h_lo, hd)

        scores = torch.einsum("bqhd,bkhd->bhqk", heads(q, 0), heads(k, 1)) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, heads(v, 2))
        return o.reshape(b_, s_, (h_hi - h_lo) * hd)
    if spec.op == "add":
        x1, x2 = inputs
        return x1 + x2
    if spec.op == "tile_concat":
        # glue always carries in_layout (built by the slicer's _glue_spec),
        # so the nested reassembly already ran above
        (x,) = inputs
        return x
    if spec.op == "concat":
        return torch.cat(list(inputs), dim=-1)
    if spec.op == "split":
        (x,) = inputs
        lo, hi = a["channels"]
        return x[..., lo:hi]
    if spec.op == "reshape":
        (x,) = inputs
        return x.reshape(x.shape[0], -1)
    if spec.op == "output":
        (x,) = inputs
        return x
    raise ValueError(spec.op)


def run_sequential(
    model: CNNModel,
    params: Params,
    x: torch.Tensor,
) -> torch.Tensor:
    """Reference execution in topological order (ACETONE's sequential code),
    on the device and in the dtype of ``x`` and ``params``."""
    vals: Dict[str, torch.Tensor] = {}
    for l in model.layers:
        ins = [x] if l.op == "input" else [vals[p] for p in l.inputs]
        vals[l.name] = apply_layer(l, params, ins)
    return vals[model.layers[-1].name]


# --------------------------------------------------------------------------- #
# model builders
# --------------------------------------------------------------------------- #
def _conv(name, parent, in_shape, features, kernel, stride=1) -> LayerSpec:
    h, w, _ = in_shape
    out = (h // stride, w // stride, features)
    return LayerSpec(name, "conv", (parent,), out,
                     {"in_shape": in_shape, "features": features,
                      "kernel": kernel, "stride": stride})


def _pool(name, op, parent, in_shape, kernel=2, stride=2) -> LayerSpec:
    h, w, c = in_shape
    out = ((h + stride - 1) // stride, (w + stride - 1) // stride, c)
    return LayerSpec(name, op, (parent,), out,
                     {"in_shape": in_shape, "kernel": kernel, "stride": stride})


def _dense(name, parent, n_in, n_out, relu=True) -> LayerSpec:
    return LayerSpec(name, "dense", (parent,), (n_out,),
                     {"in_features": n_in, "features": n_out, "relu": relu})


def lenet5(input_hw: int = 28) -> CNNModel:
    """Sequential LeNet-5 (paper Fig. 1)."""
    s = input_hw
    ls: List[LayerSpec] = [LayerSpec("input", "input", (), (s, s, 1))]
    ls.append(_conv("conv1", "input", (s, s, 1), 6, 5))
    ls.append(_pool("pool1", "maxpool", "conv1", (s, s, 6)))
    s2 = s // 2
    ls.append(_conv("conv2", "pool1", (s2, s2, 6), 16, 5))
    ls.append(_pool("pool2", "maxpool", "conv2", (s2, s2, 16)))
    s4 = s2 // 2
    flat = s4 * s4 * 16
    ls.append(LayerSpec("flatten", "reshape", ("pool2",), (flat,)))
    ls.append(_dense("dense1", "flatten", flat, 120))
    ls.append(_dense("dense2", "dense1", 120, 84))
    ls.append(_dense("dense3", "dense2", 84, 10, relu=False))
    ls.append(LayerSpec("output", "output", ("dense3",), (10,)))
    return CNNModel("lenet5", tuple(ls))


def lenet5_branchy(input_hw: int = 28) -> CNNModel:
    """Branchified LeNet-5 (paper Fig. 2): first conv/pool stage split in two."""
    s = input_hw
    ls: List[LayerSpec] = [LayerSpec("input", "input", (), (s, s, 1))]
    # the split duplicates the single input channel to both branches
    ls.append(LayerSpec("split_top", "split", ("input",), (s, s, 1), {"channels": (0, 1)}))
    ls.append(LayerSpec("split_bot", "split", ("input",), (s, s, 1), {"channels": (0, 1)}))
    ls.append(_conv("conv1_top", "split_top", (s, s, 1), 3, 5))
    ls.append(_conv("conv1_bot", "split_bot", (s, s, 1), 3, 5))
    ls.append(_pool("pool1_top", "maxpool", "conv1_top", (s, s, 3)))
    ls.append(_pool("pool1_bot", "maxpool", "conv1_bot", (s, s, 3)))
    s2 = s // 2
    ls.append(LayerSpec("concat", "concat", ("pool1_top", "pool1_bot"), (s2, s2, 6)))
    ls.append(_conv("conv2", "concat", (s2, s2, 6), 16, 5))
    ls.append(_pool("pool2", "maxpool", "conv2", (s2, s2, 16)))
    s4 = s2 // 2
    flat = s4 * s4 * 16
    ls.append(LayerSpec("flatten", "reshape", ("pool2",), (flat,)))
    ls.append(_dense("dense1", "flatten", flat, 120))
    ls.append(_dense("dense2", "dense1", 120, 84))
    ls.append(_dense("dense3", "dense2", 84, 10, relu=False))
    ls.append(LayerSpec("output", "output", ("dense3",), (10,)))
    return CNNModel("lenet5_branchy", tuple(ls))


def _inception(ls: List[LayerSpec], tag: str, parent: str, in_shape,
               f_a: int, f_b1: int, f_b2: int, f_c1: int, f_c2: int, f_d: int):
    """GoogLeNet inception module (paper Fig. 10 right box): 4 branches."""
    h, w, _ = in_shape
    ls.append(_conv(f"{tag}/conv_a", parent, in_shape, f_a, 1))
    ls.append(_conv(f"{tag}/conv_b1", parent, in_shape, f_b1, 1))
    ls.append(_conv(f"{tag}/conv_b2", f"{tag}/conv_b1", (h, w, f_b1), f_b2, 3))
    ls.append(_conv(f"{tag}/conv_c1", parent, in_shape, f_c1, 1))
    ls.append(_conv(f"{tag}/conv_c2", f"{tag}/conv_c1", (h, w, f_c1), f_c2, 5))
    ls.append(_pool(f"{tag}/maxpool", "maxpool", parent, in_shape, kernel=3, stride=1))
    ls.append(_conv(f"{tag}/conv_d", f"{tag}/maxpool", in_shape, f_d, 1))
    cout = f_a + f_b2 + f_c2 + f_d
    ls.append(LayerSpec(
        f"{tag}/concat", "concat",
        (f"{tag}/conv_a", f"{tag}/conv_b2", f"{tag}/conv_c2", f"{tag}/conv_d"),
        (h, w, cout),
    ))
    return (h, w, cout)


def inception_net(input_hw: int = 224, n_classes: int = 10) -> CNNModel:
    """The GoogLeNet-like network of paper Fig. 10 / Tables 1-3."""
    s = input_hw
    ls: List[LayerSpec] = [LayerSpec("input", "input", (), (s, s, 3))]
    ls.append(_conv("conv_1", "input", (s, s, 3), 64, 7, stride=2))
    s = s // 2
    ls.append(_pool("maxpool_1", "maxpool", "conv_1", (s, s, 64), kernel=3, stride=2))
    s = (s + 1) // 2
    ls.append(_conv("conv_2", "maxpool_1", (s, s, 64), 192, 3))
    ls.append(_pool("maxpool_2", "maxpool", "conv_2", (s, s, 192), kernel=3, stride=2))
    s = (s + 1) // 2
    shape = _inception(ls, "inception_1", "maxpool_2", (s, s, 192),
                       64, 96, 128, 16, 32, 32)
    shape = _inception(ls, "inception_2", f"inception_1/concat", shape,
                       128, 128, 192, 32, 96, 64)
    h, w, c = shape
    ls.append(_pool("avgpool", "avgpool", "inception_2/concat", shape,
                    kernel=h, stride=h))
    ls.append(LayerSpec("reshape", "reshape", ("avgpool",), (c,)))
    ls.append(_dense("gemm", "reshape", c, n_classes, relu=False))
    ls.append(LayerSpec("output", "output", ("gemm",), (n_classes,)))
    return CNNModel("inception", tuple(ls))


def transformer_block(
    seq: int = 64, d_model: int = 128, n_heads: int = 8, d_ff: int = 256
) -> CNNModel:
    """One pre-LN-free transformer block as an explicit layer DAG.

    QKV projections, multi-head attention, output projection and a 2-layer
    FFN with residual adds — the layer-granularity view the slicer lowers to
    head blocks (attention) and row blocks (dense).  Activations are
    ``(seq, d)`` per sample, so the CNN scheduling/codegen pipeline applies
    unchanged.
    """
    if d_model % n_heads:
        raise ValueError("d_model must divide into heads")
    hd = d_model // n_heads
    dm = (seq, d_model)
    proj = {"in_features": d_model, "features": d_model, "relu": False}
    ls: List[LayerSpec] = [LayerSpec("input", "input", (), dm)]
    ls.append(LayerSpec("wq", "dense", ("input",), dm, dict(proj)))
    ls.append(LayerSpec("wk", "dense", ("input",), dm, dict(proj)))
    ls.append(LayerSpec("wv", "dense", ("input",), dm, dict(proj)))
    ls.append(LayerSpec("attn", "attn", ("wq", "wk", "wv"), dm,
                        {"n_heads": n_heads, "head_dim": hd, "seq": seq}))
    ls.append(LayerSpec("wo", "dense", ("attn",), dm, dict(proj)))
    ls.append(LayerSpec("res1", "add", ("input", "wo"), dm))
    ls.append(LayerSpec("ffn1", "dense", ("res1",), (seq, d_ff),
                        {"in_features": d_model, "features": d_ff, "relu": True}))
    ls.append(LayerSpec("ffn2", "dense", ("ffn1",), dm,
                        {"in_features": d_ff, "features": d_model, "relu": False}))
    ls.append(LayerSpec("res2", "add", ("res1", "ffn2"), dm))
    ls.append(LayerSpec("output", "output", ("res2",), dm))
    return CNNModel("transformer_block", tuple(ls))
