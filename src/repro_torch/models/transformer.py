"""Model assembly for every family of the registry (dense, MoE/MLA, SSM,
hybrid, audio encoder and VLM): parameters, cache and the three entry points.

Port of ``repro/models/transformer.py``.  :func:`segments` is the reference's
structural plan, copied verbatim: a list of segments, each ``repeat`` times
a pattern of (mixer, ffn) positions.  The reference stacks each position's
parameters under ``segments/<name>/p<j>`` with a leading ``[repeat]`` dim
and runs them with ``lax.scan``; here each layer is a :class:`Block`
(attention, GQA or MLA, then a SwiGLU or MoE FFN) or an :class:`SSMBlock`
(a mamba2 mixer, then no FFN in a pure SSM model, a SwiGLU or MoE FFN in
Jamba's hybrid ``super`` segment) in an ``nn.ModuleList`` in layer order,
and the scan is a Python loop (``Transformer.plan`` maps layer i to its segment,
position j and repeat k: i = segment offset + k·P + j).  The cache keeps
the reference's tree and stacked layouts (``[repeat, B, Smax, KV, D]``
k/v; ``[repeat, B, Smax, r]`` MLA latent and ``[repeat, B, Smax, rope]``
key; ``[repeat, B, w-1, CH]`` conv window and ``[repeat, B, H, P, N]``
state), and is updated in place.  ``constrain`` (mesh sharding hints) has
no counterpart on one card.  The reference's ``ParamDef`` trees
(:func:`model_defs`, :func:`cache_model_defs`) are the one source of
shapes, dtypes and initializers: the modules build their parameters from
each layer's :func:`block_defs`, and :func:`init_params` and
:func:`init_cache` read them.

Three entry points share parameters:

* ``forward(..., mode="train")``   — full-sequence logits; ``remat=True``
  recomputes each repeat of a segment's pattern in the backward
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` around its
  scan step), so every kernel of a layer launches twice under training.
* ``forward(..., mode="prefill")`` — logits + populated cache.
* ``decode_step``                   — one token against the cache.

Both take ``moe_impl`` (``"einsum"`` or ``"scatter"``), as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.parallel.sharding import ParamDef, abstract_tree, tree_map_defs
from repro_torch.runtime import spans

__all__ = ["Transformer", "Block", "SSMBlock", "LayerSlot", "segments", "layer_plan",
           "block_defs", "model_defs", "cache_defs_for", "cache_model_defs", "named_defs",
           "abstract_params", "abstract_cache", "init_params", "init_cache", "forward",
           "decode_step"]


# --------------------------------------------------------------------------- #
# block defs per layer kind (the reference's ParamDef trees)
# --------------------------------------------------------------------------- #
def _attn_defs(cfg: ArchConfig) -> Dict[str, Any]:
    mix = L.mla_defs(cfg) if cfg.mla is not None else L.attention_defs(cfg)
    return {"ln1": L.rmsnorm_defs(cfg.d_model), "attn": mix}


def _ffn_defs(cfg: ArchConfig, kind: str) -> Dict[str, Any]:
    if kind == "moe":
        return {"ln2": L.rmsnorm_defs(cfg.d_model), "moe": L.moe_defs(cfg)}
    if kind == "dense":
        return {"ln2": L.rmsnorm_defs(cfg.d_model), "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff)}
    if kind == "none":
        return {}
    raise ValueError(kind)


def block_defs(cfg: ArchConfig, mixer: str, ffn: str) -> Dict[str, Any]:
    """mixer: attn | ssm;  ffn: dense | moe | none."""
    if mixer == "ssm":
        out = {"ln1": L.rmsnorm_defs(cfg.d_model), "ssm": S.ssm_defs(cfg)}
    else:
        out = _attn_defs(cfg)
    out.update(_ffn_defs(cfg, ffn))
    return out


# --------------------------------------------------------------------------- #
# cache defs per layer kind
# --------------------------------------------------------------------------- #
def _attn_cache_defs(cfg: ArchConfig, batch: int, max_seq: int) -> Dict[str, ParamDef]:
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "c_kv": ParamDef((batch, max_seq, m.kv_lora_rank),
                             ("batch", "kvseq", None), init="zeros"),
            "k_rope": ParamDef((batch, max_seq, m.rope_head_dim),
                               ("batch", "kvseq", None), init="zeros"),
        }
    return {
        "k": ParamDef((batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
                      ("batch", "kvseq", "kv_heads", None), init="zeros"),
        "v": ParamDef((batch, max_seq, cfg.n_kv_heads, cfg.head_dim),
                      ("batch", "kvseq", "kv_heads", None), init="zeros"),
    }


def cache_defs_for(cfg: ArchConfig, mixer: str, batch: int, max_seq: int):
    if mixer == "ssm":
        return S.ssm_cache_defs(cfg, batch)
    return _attn_cache_defs(cfg, batch, max_seq)


def segments(cfg: ArchConfig) -> List[Dict[str, Any]]:
    """Structural plan: list of segments, each a stacked scan of one block
    pattern.  A segment's ``pattern`` is a list of (mixer, ffn) applied
    positionally (unrolled) inside each scan step."""
    if cfg.family == "ssm":
        return [{"name": "ssm", "repeat": cfg.n_layers, "pattern": [("ssm", "none")]}]
    if cfg.hybrid is not None:
        period = cfg.hybrid.attn_period
        assert cfg.n_layers % period == 0
        pat = []
        for j in range(period):
            mixer = "attn" if j == cfg.hybrid.attn_offset else "ssm"
            ffn = "moe" if cfg.is_moe_layer(j) else "dense"
            pat.append((mixer, ffn))
        return [{"name": "super", "repeat": cfg.n_layers // period, "pattern": pat}]
    if cfg.moe is not None:
        segs = []
        fd = cfg.moe.first_dense
        if fd:
            segs.append({"name": "lead", "repeat": fd, "pattern": [("attn", "dense")]})
        rest = cfg.n_layers - fd
        if cfg.moe.every == 1:
            segs.append({"name": "moe", "repeat": rest, "pattern": [("attn", "moe")]})
        else:
            per = cfg.moe.every
            assert rest % per == 0
            pat = [("attn", "moe" if cfg.is_moe_layer(fd + j) else "dense")
                   for j in range(per)]
            segs.append({"name": "moe", "repeat": rest // per, "pattern": pat})
        return segs
    return [{"name": "dense", "repeat": cfg.n_layers, "pattern": [("attn", "dense")]}]


def _stack_defs(defs, n: int):
    """Prepend a stacked [n] 'layers' dim to every ParamDef in the tree."""
    def f(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, shape=(n, *d.shape), axes=("layers", *d.axes))
    return tree_map_defs(f, defs)


# --------------------------------------------------------------------------- #
# whole-model defs
# --------------------------------------------------------------------------- #
def model_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, V = cfg.d_model, cfg.vocab
    out: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": L.rmsnorm_defs(d),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamDef((d, V), ("embed", "vocab"))
    segs = {}
    for seg in segments(cfg):
        pos_defs = [block_defs(cfg, mixer, ffn) for (mixer, ffn) in seg["pattern"]]
        segs[seg["name"]] = _stack_defs(
            {f"p{j}": pd for j, pd in enumerate(pos_defs)}, seg["repeat"]
        )
    out["segments"] = segs
    return out


def cache_model_defs(cfg: ArchConfig, batch: int, max_seq: int) -> Dict[str, Any]:
    segs = {}
    for seg in segments(cfg):
        pos = {}
        for j, (mixer, _ffn) in enumerate(seg["pattern"]):
            pos[f"p{j}"] = cache_defs_for(cfg, mixer, batch, max_seq)
        segs[seg["name"]] = _stack_defs(pos, seg["repeat"])
    return {"segments": segs}


def abstract_params(cfg: ArchConfig):
    """:func:`model_defs` as ``meta`` tensors, in the reference's stacked tree."""
    return abstract_tree(model_defs(cfg))


def abstract_cache(cfg: ArchConfig, batch: int, max_seq: int):
    """:func:`cache_model_defs` as ``meta`` tensors, with ``init_cache``'s
    scalar ``pos``."""
    c = abstract_tree(cache_model_defs(cfg, batch, max_seq))
    c["pos"] = torch.empty((), dtype=torch.int64, device="meta")
    return c


def _leaf_dtype(d: ParamDef, dtype: torch.dtype) -> torch.dtype:
    """A leaf's dtype in a model (or cache) of ``dtype``: the leaves the
    reference keeps in f32 whatever the rest (the router, ``dt_bias``,
    ``A_log``, ``Dskip``; the SSM state) stay f32."""
    return torch.float32 if d.dtype == torch.float32 else dtype


def _param(d: ParamDef, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(d.shape, device=device, dtype=_leaf_dtype(d, dtype)),
                        requires_grad=False)


def _pdict(defs: Dict[str, ParamDef], device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({n: _param(d, device, dtype) for n, d in defs.items()})


class MoEParams(nn.Module):
    """A MoE layer's leaves, addressed as the reference's tree is
    (``p["router"]``, ``p["shared"]["wg"]``): the router in f32 whatever the
    model's dtype, the stacked expert weights, and the shared experts'
    and the dense residual's MLPs where the config has them."""

    def __init__(self, defs: Dict[str, Any], device=None, dtype=torch.bfloat16):
        super().__init__()
        for name, d in defs.items():
            if isinstance(d, dict):
                setattr(self, name, _pdict(d, device, dtype))
            else:
                self.register_parameter(name, _param(d, device, dtype))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _add_leaves(block: nn.Module, defs: Dict[str, Any], device, dtype) -> None:
    """A layer's leaves from its :func:`block_defs`, in their order: ``ln1``,
    the mixer (``attn`` or ``ssm``), then ``ln2`` and a SwiGLU ``mlp`` or a
    ``moe`` layer where the layer has an FFN."""
    for name, sub in defs.items():
        setattr(block, name, (MoEParams if name == "moe" else _pdict)(sub, device, dtype))


def _apply_ffn(block: nn.Module, cfg: ArchConfig, x: torch.Tensor, moe_impl: str,
               mode: str = "train"):
    """``_apply_ffn`` of the reference: the residual FFN, if the layer has one
    (``mode`` names the MoE layer's counters)."""
    if hasattr(block, "moe"):
        with spans.span("model.moe"):
            h = L.rmsnorm(block.ln2, x, cfg.norm_eps)
            return x + L.moe_layer(block.moe, cfg, h, impl=moe_impl, mode=mode)
    if hasattr(block, "mlp"):
        with spans.span("model.mlp"):
            return x + L.mlp(block.mlp, L.rmsnorm(block.ln2, x, cfg.norm_eps))
    return x


class Block(nn.Module):
    """One pre-norm decoder (or encoder) layer: rmsnorm → attention (GQA, or
    MLA where the config has it) → rmsnorm → FFN (``ffn``: a SwiGLU
    ``"dense"`` or a ``"moe"`` layer)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16, ffn: str = "dense"):
        super().__init__()
        _add_leaves(self, block_defs(cfg, "attn", ffn), device, dtype)

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str, moe_impl: str = "einsum"):
        with spans.span("model.attn"):
            h = L.rmsnorm(self.ln1, x, cfg.norm_eps)
            mla = cfg.mla is not None
            if mode == "decode":
                attend = L.mla_attention_decode if mla else L.attention_decode
                o, _ = attend(self.attn, cfg, h, cache, pos)
            elif mode == "prefill":
                attend = L.mla_attention_prefill if mla else L.attention_prefill
                o, _ = attend(self.attn, cfg, h, cache)
            else:
                o = (L.mla_attention_full if mla else L.attention_full)(self.attn, cfg, h)
            x = x + o
        return _apply_ffn(self, cfg, x, moe_impl, mode)


class SSMBlock(nn.Module):
    """One pre-norm mamba2 layer: rmsnorm → SSD mixer, then the FFN a hybrid
    pattern gives the position (``ffn``: ``"none"`` in a pure SSM model, a
    SwiGLU ``"dense"`` or a ``"moe"`` layer in Jamba's ``super`` segment).
    ``dt_bias``, ``A_log`` and ``Dskip`` stay f32 whatever the model's
    dtype, as in the reference."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16, ffn: str = "none"):
        super().__init__()
        _add_leaves(self, block_defs(cfg, "ssm", ffn), device, dtype)

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str, moe_impl: str = "einsum"):
        with spans.span("model.ssm"):
            o, _ = S.ssm_block(self.ssm, cfg, L.rmsnorm(self.ln1, x, cfg.norm_eps), cache, pos,
                               mode)
            x = x + o
        return _apply_ffn(self, cfg, x, moe_impl, mode)


class LayerSlot(NamedTuple):
    """Where layer i sits in the reference's tree: segment, position j of
    its pattern, repeat k (i = the segment's offset + k·P + j)."""
    segment: str
    j: int
    k: int
    mixer: str
    ffn: str


def layer_plan(cfg: ArchConfig) -> List[LayerSlot]:
    """Every layer's slot, in layer order (the reference's scan order)."""
    return [LayerSlot(seg["name"], j, k, mixer, ffn)
            for seg in segments(cfg) for k in range(seg["repeat"])
            for j, (mixer, ffn) in enumerate(seg["pattern"])]


class Transformer(nn.Module):
    """Parameters of an LM of any family of the registry (``model_defs`` of
    the reference) on one device, one module a layer, in layer order: each
    slot's (mixer, ffn) of :func:`segments` makes a :class:`Block` or an
    :class:`SSMBlock`."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        defs = model_defs(cfg)
        self.embed = _param(defs["embed"], device, dtype)
        self.final_norm = _pdict(defs["final_norm"], device, dtype)
        self.lm_head = None if cfg.tie_embeddings else _param(defs["lm_head"], device, dtype)
        self.plan = layer_plan(cfg)
        self.layers = nn.ModuleList(
            (SSMBlock if slot.mixer == "ssm" else Block)(cfg, device, dtype, ffn=slot.ffn)
            for slot in self.plan)


def _flat_defs(defs: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, ParamDef]]:
    for name, d in defs.items():
        if isinstance(d, ParamDef):
            yield prefix + name, d
        else:
            yield from _flat_defs(d, f"{prefix}{name}.")


def named_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    """Each parameter of :class:`Transformer` by its name, with its
    ``ParamDef``: the top leaves of :func:`model_defs` and each layer's
    :func:`block_defs` (the unstacked defs of its segment position)."""
    top = {k: v for k, v in model_defs(cfg).items() if k != "segments"}
    out = dict(_flat_defs(top))
    for i, slot in enumerate(layer_plan(cfg)):
        out.update(_flat_defs(block_defs(cfg, slot.mixer, slot.ffn), f"layers.{i}."))
    return out


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda", dtype=torch.bfloat16) -> Transformer:
    """Random weights drawn as each leaf's ``ParamDef`` says
    (:func:`named_defs`, :meth:`ParamDef.materialize`): normals at
    ``default_scale`` (``embed`` at 0.02,
    ``conv_w`` at 1/conv_width), ones, zeros.  ``default_scale`` takes
    ``shape[-2]`` as the fan-in, which for ``wq``/``wk``/``wv``
    ``[d, H, Dh]`` and MLA's ``wq [d, H, nope+rope]`` and ``w_uk``/``w_uv
    [r, H, *]`` is the head count, as in the reference.  The router and the
    SSM's f32 leaves stay f32.
    The normals come from ``generator``, leaf by leaf in parameter order
    (drawn in f32 on its device, scaled in place, then cast: one f32
    temporary of the largest leaf, 16.6 GiB for Arctic's experts), so they
    differ from ``jax.random``'s; tests that compare the two packages
    convert the reference's weights with ``params_from_numpy`` instead."""
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta", dtype=dtype)
    defs = named_defs(cfg)
    for name, prm in list(model.named_parameters()):
        # each leaf allocated as it is drawn (ParamDef.materialize): one f32
        # temporary, freed before the next leaf's draw
        owner, _, leaf = name.rpartition(".")
        value = defs[name].materialize(generator, dev, prm.dtype)
        setattr(model.get_submodule(owner), leaf, nn.Parameter(value, requires_grad=False))
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda", dtype=torch.bfloat16):
    """Zeroed cache in the reference's tree (:func:`cache_model_defs`:
    ``segments/<name>/p<j>``, each leaf stacked over the segment's repeats),
    with a scalar ``pos``: k/v or MLA's latent and rope key in ``dtype``
    (bf16, ``ParamDef``'s default, whatever the params are), or the SSM's
    conv window in ``dtype`` and its state in f32.  ``max_seq`` is unused by
    an SSM."""
    dev = resolve_device(device)
    c = tree_map_defs(lambda d: torch.zeros(d.shape, dtype=_leaf_dtype(d, dtype), device=dev),
                      cache_model_defs(cfg, batch, max_seq))
    c["pos"] = torch.zeros((), dtype=torch.int64, device=dev)
    return c


def _embed(params: Transformer, inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference's ``_embed``: frontend ``embeds`` [B, S_e, d] (cast to
    the embedding's dtype), then the ``tokens``' embeddings, concatenated
    along the sequence; either may be absent."""
    parts = []
    if inputs.get("embeds") is not None:
        parts.append(inputs["embeds"].to(params.embed.dtype))
    if inputs.get("tokens") is not None:
        parts.append(params.embed[inputs["tokens"]])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _unembed(params: Transformer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params.embed)
    return torch.einsum("bsd,dv->bsv", x, params.lm_head)


def _run_layers(params: Transformer, cfg: ArchConfig, x, cache, pos, mode: str,
                moe_impl: str, remat: bool = False):
    if remat:
        # one checkpoint per repeat of a segment's pattern: the reference's
        # jax.checkpoint around its scan step (its save policy changes no
        # values); a repeat's layers are consecutive in layer order
        groups: Dict[Tuple[str, int], List[int]] = {}
        for i, slot in enumerate(params.plan):
            groups.setdefault((slot.segment, slot.k), []).append(i)
        for idx in groups.values():
            x = checkpoint(_run_group, params, cfg, x, cache, pos, mode, moe_impl, idx,
                           use_reentrant=False)
        return x
    return _run_group(params, cfg, x, cache, pos, mode, moe_impl, range(len(params.layers)))


def _run_group(params: Transformer, cfg: ArchConfig, x, cache, pos, mode: str, moe_impl: str,
               idx):
    for i in idx:
        with spans.span("model.layer"):
            slot, block = params.plan[i], params.layers[i]
            layer_cache = None
            if cache is not None:
                leaves = cache["segments"][slot.segment][f"p{slot.j}"]
                layer_cache = {n: t[slot.k] for n, t in leaves.items()}
            x = block(cfg, x, layer_cache, pos, mode, moe_impl)
    return x


def forward(params: Transformer, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
            mode: str = "train", cache=None, moe_impl: str = "einsum", remat: bool = False):
    """inputs: {tokens: [B,S] int} and/or {embeds: [B,S,d]} (frontend
    embeddings, which come first; ``models/frontends.py``).

    mode="train": returns logits.  mode="prefill": returns (logits, cache);
    ``cache`` must be a fresh ``init_cache`` tree, and is filled in place.
    ``moe_impl``: the MoE layers' dispatch, ``"einsum"`` or ``"scatter"``.
    ``remat``: recompute each repeat of a segment in the backward (train).
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    if remat and mode != "train":
        raise ValueError("remat applies to mode='train'")
    with spans.span("model.embed"):
        x = _embed(params, inputs)
    x = _run_layers(params, cfg, x, cache if mode == "prefill" else None, None, mode, moe_impl,
                    remat)
    with spans.span("model.unembed"):
        logits = _unembed(params, cfg, x)
    if mode == "prefill":
        cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int64, device=x.device)
        return logits, cache
    return logits


def decode_step(params: Transformer, cfg: ArchConfig, cache, tokens: torch.Tensor,
                moe_impl: str = "einsum"):
    """One decode step: tokens [B,1] -> (logits [B,1,V], cache updated in place)."""
    with spans.span("model.embed"):
        x = params.embed[tokens]
    pos = cache["pos"]
    x = _run_layers(params, cfg, x, cache, pos, "decode", moe_impl)
    with spans.span("model.unembed"):
        logits = _unembed(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache
