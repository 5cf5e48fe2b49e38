"""A cell's operands as ``meta`` tensors, and their partition specs.

Port of ``repro/launch/specs.py``.  ``input_specs(cfg, shape)`` gives the
inputs of the cell's step (train / prefill / decode) as ``meta`` tensors,
the port's counterpart of ``jax.ShapeDtypeStruct`` (nothing allocated);
:func:`cell_pspecs` gives every operand tree of the step with the
:class:`PartitionSpec` each leaf takes on a mesh of a given shape, under
``TRAIN_RULES``/``SERVE_RULES`` (parameters, cache), ``OPT_RULES`` (the
moments) and the batch rule.  The reference's ``cell_shardings`` resolves
``NamedSharding``s on a ``jax.sharding.Mesh``; the port has no mesh, and the
specs are what such shardings are built from.

Dtypes are the reference's, with one difference: the cache's ``pos`` is
int64 here (int32 in the reference), as the port's ``init_cache`` makes it.
Tokens and labels are int32 in both (the port's models index with them as
they are).  The moments are f32, or bf16 where ``bf16_moments`` says (by
default for models of more than 2e11 parameters), as the reference's
``lower_cell`` sets them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.frontends import frontend_token_split
from repro_torch.parallel.sharding import (
    OPT_RULES,
    SERVE_RULES,
    TRAIN_RULES,
    PartitionSpec as P,
    logical_to_pspec,
    tree_map_defs,
    tree_pspecs,
)

__all__ = ["input_specs", "cell_pspecs", "microbatches_for", "default_bf16_moments",
           "per_device_bytes", "CellSpec"]


def _batch_pspec(mesh_shape: Mapping[str, int], ndim: int, dim_sizes) -> P:
    axes = ["batch"] + [None] * (ndim - 1)
    return logical_to_pspec(axes, dim_sizes, TRAIN_RULES, mesh_shape)


def microbatches_for(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: Mapping[str, int]) -> int:
    """Gradient-accumulation depth: ~1 sequence per data shard per microbatch
    for big models, 4 for small ones (keeps activation memory ≈ constant)."""
    if shape.kind != "train":
        return 1
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    per_shard = max(shape.global_batch // dp, 1)
    seqs_per_micro = 4 if cfg.d_model < 2048 else 1
    return max(1, per_shard // seqs_per_micro)


def default_bf16_moments(cfg: ArchConfig) -> bool:
    """The reference's default: bf16 moments for models of more than 2e11
    parameters."""
    return cfg.param_count()[0] > 2e11


def input_specs(cfg: ArchConfig, shape: ShapeSpec, device="meta",
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The inputs of the cell's step: ``embeds`` [B, n_emb, d] bf16 and/or
    ``tokens`` [B, n_txt] int32 (the frontend's split), and for train
    ``labels`` [B, n_txt or n_emb] int32; for decode ``tokens`` [B, 1].  On
    ``meta`` (the default) nothing is allocated; on another device the
    values are drawn from ``generator`` (tokens and labels uniform over the
    vocabulary, embeds normal at 0.02)."""
    B, S = shape.global_batch, shape.seq_len
    sizes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if shape.kind in ("train", "prefill"):
        n_emb, n_txt = frontend_token_split(cfg, S)
        if n_emb:
            sizes["embeds"] = ((B, n_emb, cfg.d_model), torch.bfloat16)
        if n_txt:
            sizes["tokens"] = ((B, n_txt), torch.int32)
        if shape.kind == "train":
            sizes["labels"] = ((B, n_txt if n_txt else n_emb), torch.int32)
    else:  # decode: one new token against a seq_len cache
        sizes["tokens"] = ((B, 1), torch.int32)
    dev = torch.device(device)
    if dev.type == "meta":
        return {k: torch.empty(s, dtype=dt, device=dev) for k, (s, dt) in sizes.items()}
    if generator is None:
        raise ValueError("input_specs: values on a real device need a generator")
    out = {}
    for k, (s, dt) in sizes.items():
        if dt == torch.int32:
            t = torch.randint(0, cfg.vocab, s, generator=generator, device=generator.device,
                              dtype=dt)
        else:
            t = torch.randn(s, generator=generator, device=generator.device).mul_(0.02)
        out[k] = t.to(device=dev, dtype=dt)
    return out


@dataclasses.dataclass
class CellSpec:
    """One (arch × shape × mesh) cell: the step's operands as ``meta``
    tensors (``abstract_args``: parameters and cache in the reference's
    stacked trees), the partition spec of each leaf (``pspecs``, the same
    structure), and the operands the step donates (updates in place)."""
    kind: str
    abstract_args: Tuple[Any, ...]
    pspecs: Tuple[Any, ...]
    donate_argnums: Tuple[int, ...]


def _batch_pspecs(mesh_shape: Mapping[str, int], inputs) -> Dict[str, P]:
    return {k: _batch_pspec(mesh_shape, v.dim(), tuple(v.shape)) for k, v in inputs.items()}


def cell_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh_shape: Mapping[str, int],
                bf16_moments: Optional[bool] = None) -> CellSpec:
    defs = T.model_defs(cfg)
    train = shape.kind == "train"
    param_ps = tree_pspecs(defs, TRAIN_RULES if train else SERVE_RULES, mesh_shape)
    params = T.abstract_params(cfg)
    inputs = input_specs(cfg, shape)
    batch_ps = _batch_pspecs(mesh_shape, inputs)

    if train:
        bf16_m = default_bf16_moments(cfg) if bf16_moments is None else bf16_moments
        mdt = torch.bfloat16 if bf16_m else torch.float32
        def moments():
            return tree_map_defs(lambda d: torch.empty(d.shape, dtype=mdt, device="meta"), defs)

        opt = {"m": moments(), "v": moments(),
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        opt_ps = {"m": tree_pspecs(defs, OPT_RULES, mesh_shape),
                  "v": tree_pspecs(defs, OPT_RULES, mesh_shape), "step": P()}
        return CellSpec("train", (params, opt, inputs), (param_ps, opt_ps, batch_ps), (0, 1))

    cache_defs = T.cache_model_defs(cfg, shape.global_batch, shape.seq_len)
    cache_ps = {"segments": tree_pspecs(cache_defs, SERVE_RULES, mesh_shape)["segments"],
                "pos": P()}
    cache = T.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return CellSpec("prefill", (params, cache, inputs), (param_ps, cache_ps, batch_ps), (1,))
    return CellSpec("decode", (params, cache, inputs["tokens"]),
                    (param_ps, cache_ps, batch_ps["tokens"]), (1,))


def _ways(spec: P, mesh_shape: Mapping[str, int]) -> int:
    n = 1
    for names in spec:
        for nm in (() if names is None else names if isinstance(names, tuple) else (names,)):
            n *= mesh_shape[nm]
    return n


def per_device_bytes(cell: CellSpec, mesh_shape: Mapping[str, int]) -> float:
    """The bytes of the cell's operands that one device of the mesh holds:
    each leaf's bytes over the ways its spec splits it (a leaf whose spec
    names no axis is whole on every device).  On one card: every byte."""
    total = 0.0

    def walk(arg, spec):
        nonlocal total
        if isinstance(arg, torch.Tensor):
            total += arg.numel() * arg.element_size() / _ways(spec, mesh_shape)
            return
        for k in arg:
            walk(arg[k], spec[k])

    for arg, spec in zip(cell.abstract_args, cell.pspecs):
        walk(arg, spec)
    return total
