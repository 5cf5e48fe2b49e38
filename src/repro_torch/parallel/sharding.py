"""Logical-axis sharding rules and parameter definitions.

Port of ``repro/parallel/sharding.py``.  Every parameter and cache
dimension carries a *logical* axis name ("embed", "heads", "experts", ...).
A policy (:class:`AxisRules`) maps each logical name to a preference list of
mesh axes, and :func:`logical_to_pspec` resolves a tensor's logical axes into
a :class:`PartitionSpec` for a mesh of given axis sizes, with the
reference's divisibility and exclusivity rules.  The policies, the resolver
and ``mesh_axis_size`` are the reference's text; ``PartitionSpec`` is the
port's own tuple type with ``jax.sharding.PartitionSpec``'s entries (``None``,
a mesh axis, or a tuple of them; trailing ``None`` trimmed), so specs compare
equal to the reference's as tuples.

:class:`ParamDef` is the one source of truth for a leaf's shape, logical
axes, dtype (a torch dtype), initializer and scale: the model's
``init_params`` and ``init_cache`` read shapes, dtypes and initializers
from the trees of them (``models/transformer.py``), and
:func:`abstract_tree` gives ``meta`` tensors, which allocate nothing.
``default_scale`` keeps the reference's fan-in of ``shape[-2]``, which the
port reproduces (for ``wq``/``wk``/``wv`` that is the head count).

:meth:`ParamDef.materialize` draws one leaf (ones, zeros, or normals at
``default_scale``) from a ``torch.Generator``, and :func:`init_tree` a tree
of them, leaf by leaf in the tree's order from the one generator (the
reference splits one ``jax.random`` key per leaf, so the values differ).

The reference's ``constrain`` (``with_sharding_constraint`` inside a mesh)
and ``tree_shardings`` (``NamedSharding`` over a ``jax.sharding.Mesh``)
have no counterpart on one card: the port places every tensor on its one
device, and :func:`tree_pspecs` gives the same specs a mesh would be handed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "AxisRules",
    "ParamDef",
    "PartitionSpec",
    "TRAIN_RULES",
    "OPT_RULES",
    "SERVE_RULES",
    "logical_to_pspec",
    "abstract_tree",
    "init_tree",
    "tree_map_defs",
    "tree_pspecs",
    "mesh_axis_size",
]


class PartitionSpec(tuple):
    """A partition spec: one entry per leading dimension (``None``, a mesh
    axis name, or a tuple of names), trailing ``None`` trimmed by
    :func:`logical_to_pspec`; ``PartitionSpec("data", None)`` as
    ``jax.sharding.PartitionSpec`` is written."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# --------------------------------------------------------------------------- #
# policies
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> tuple of candidate mesh axes (in order)."""

    name: str
    rules: Mapping[str, Tuple[str, ...]]

    def candidates(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return tuple(self.rules.get(logical, ()))


TRAIN_RULES = AxisRules(
    name="train",
    rules={
        # activations
        "batch": ("pod", "data"),
        "seq": (),
        "kvseq": ("model",),        # score/context sharding for long prefill
        # parameters — TP family over `model`
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": (),
        # head_dim TP fallback (§Perf i4): when the head count doesn't
        # divide the model axis (qwen2.5's 40, arctic's 56, qwen2's 14),
        # shard head_dim instead — attention weights then stop being
        # FSDP-regathered every microbatch (was the dominant collective)
        "qk": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "expert_embed": (),          # never FSDP-gathered (§Perf i5)
        "expert_ffn": ("data",),     # TP over data: psum, not gather
        # parameters — ZeRO/FSDP family over `data`
        "embed": ("data",),
        "ssm_inner": ("model",),
        "state": (),
        "layers": (),
    },
)

# Optimizer state (and grad accumulators): fully sharded over BOTH axes —
# ZeRO-style.  Same rules as train except `embed` may also consume `model`
# when the TP family left it free, pushing m/v/grad to (data×model)-way.
OPT_RULES = AxisRules(
    name="opt",
    rules=dict(TRAIN_RULES.rules, embed=("data", "model")),
)

SERVE_RULES = AxisRules(
    name="serve",
    rules={
        "batch": ("pod", "data"),
        "seq": (),
        "kvseq": ("model",),        # seq-sharded KV cache (flash-decode)
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": (),
        "qk": ("model",),           # head_dim TP when head count won't divide
        # 2-D TP for FFN/expert weights at serve (§Perf i4): arctic's 960 GB
        # of expert weights only 16-way sharded = 58 GiB/chip; adding `data`
        # makes them 256-way (3.75 GiB) with activation psums instead of
        # weight gathers — the right trade for decode's tiny activations
        "ffn": ("model", "data"),
        "experts": ("model",),
        "expert_embed": (),
        "expert_ffn": ("data",),
        "embed": (),                # no FSDP at serve time: weights stay put
        "ssm_inner": ("model",),
        "state": (),
        "layers": (),
    },
)


def mesh_axis_size(mesh_shape: Mapping[str, int], axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh_shape.get(a, 1)
    return n


def logical_to_pspec(
    logical_axes: Sequence[Optional[str]],
    dim_sizes: Sequence[int],
    rules: AxisRules,
    mesh_shape: Mapping[str, int],
) -> P:
    """Resolve logical axes into a PartitionSpec for a concrete mesh.

    Two-phase greedy: phase 1 gives every dim (left to right) at most ONE
    mesh axis — its first unclaimed, divisibility-compatible candidate — so
    an early dim with a long candidate list (e.g. ZeRO's ``embed``) cannot
    starve a later dim's primary TP axis.  Phase 2 revisits dims and extends
    each with its remaining candidates if still unclaimed and divisible.
    """
    if len(logical_axes) != len(dim_sizes):
        raise ValueError(
            f"logical axes {logical_axes} rank != shape {tuple(dim_sizes)} rank"
        )
    used: set = set()
    picked: list = [[] for _ in logical_axes]
    prods: list = [1 for _ in logical_axes]

    def try_claim(i: int, name: Optional[str], size: int, limit: int) -> None:
        for cand in rules.candidates(name):
            if len(picked[i]) >= limit:
                return
            if cand in used or cand not in mesh_shape:
                continue
            nxt = prods[i] * mesh_shape[cand]
            if size % nxt != 0:
                continue
            picked[i].append(cand)
            prods[i] = nxt
            used.add(cand)

    for i, (name, size) in enumerate(zip(logical_axes, dim_sizes)):
        try_claim(i, name, size, limit=1)
    for i, (name, size) in enumerate(zip(logical_axes, dim_sizes)):
        try_claim(i, name, size, limit=8)

    out: list = []
    for p in picked:
        if not p:
            out.append(None)
        elif len(p) == 1:
            out.append(p[0])
        else:
            out.append(tuple(p))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


# --------------------------------------------------------------------------- #
# parameter definitions
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + logical axes + dtype + initializer of one parameter (or
    cache) tensor: the single source of truth that the port's
    ``init_params``/``init_cache`` (materialise), :func:`abstract_tree`
    (``meta`` tensors) and :func:`tree_pspecs` (shardings) read."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in = shape[-2] or [-1])

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")

    def default_scale(self) -> float:
        if self.scale is not None:
            return self.scale
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))

    def materialize(self, generator: torch.Generator, device=None,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """This leaf on ``device`` (default: the generator's) in ``dtype``
        (default: its own): ones, zeros, or normals at
        :meth:`default_scale`, drawn from ``generator`` in f32 on the
        generator's device, scaled in place, then cast and moved.  On
        ``meta`` nothing is drawn (the generator does not advance)."""
        dev = torch.device(generator.device if device is None else device)
        dtype = self.dtype if dtype is None else dtype
        if dev.type == "meta" or self.init == "zeros":
            make = torch.empty if dev.type == "meta" else torch.zeros
            return make(self.shape, dtype=dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=dev)
        if self.init == "normal":
            draw = torch.randn(self.shape, generator=generator, device=generator.device)
            return draw.mul_(self.default_scale()).to(device=dev, dtype=dtype)
        raise ValueError(f"unknown init {self.init!r}")

    def abstract(self) -> torch.Tensor:
        """A ``meta`` tensor of this shape and dtype (nothing allocated)."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")

    def pspec(self, rules: AxisRules, mesh_shape: Mapping[str, int]) -> P:
        return logical_to_pspec(self.axes, self.shape, rules, mesh_shape)


def tree_map_defs(fn, defs):
    """``fn`` applied to every :class:`ParamDef` of a tree of nested dicts."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: tree_map_defs(fn, v) for k, v in defs.items()}


def abstract_tree(defs) -> Any:
    """The tree of ``meta`` tensors (the reference's ``ShapeDtypeStruct``s)."""
    return tree_map_defs(ParamDef.abstract, defs)


def init_tree(defs, generator: torch.Generator, device=None) -> Any:
    """Every leaf of a tree of :class:`ParamDef` materialised from
    ``generator``, in the tree's order."""
    return tree_map_defs(lambda d: d.materialize(generator, device), defs)


def tree_pspecs(defs, rules: AxisRules, mesh_shape: Mapping[str, int]):
    return tree_map_defs(lambda d: d.pspec(rules, mesh_shape), defs)
