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
no counterpart on one card.

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

import math
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

__all__ = ["Transformer", "Block", "SSMBlock", "LayerSlot", "segments", "layer_plan",
           "init_params", "init_cache", "forward", "decode_step"]

# parameter leaves by initializer (``ParamDef.init`` in the reference)
_ONES = {"scale", "q_norm", "k_norm", "kv_norm", "Dskip", "norm"}
_ZEROS = {"bq", "bk", "bv", "dt_bias", "A_log", "conv_b"}
_EMBED_SCALE = 0.02


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


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _pdict(shapes: Dict[str, Tuple[int, ...]], device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({n: _param(s, device, dtype) for n, s in shapes.items()})


class MoEParams(nn.Module):
    """A MoE layer's leaves, addressed as the reference's tree is
    (``p["router"]``, ``p["shared"]["wg"]``): the router in f32 whatever the
    model's dtype, the stacked expert weights, and the shared experts'
    and the dense residual's MLPs where the config has them."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        for name, shape in L.moe_defs(cfg).items():
            if isinstance(shape, dict):
                setattr(self, name, _pdict(shape, device, dtype))
            else:
                dt = torch.float32 if name in L.MOE_F32_LEAVES else dtype
                self.register_parameter(name, _param(shape, device, dt))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _add_ffn(block: nn.Module, cfg: ArchConfig, ffn: str, device, dtype) -> None:
    """A layer's FFN leaves (``_ffn_defs`` of the reference): ``ln2`` and a
    SwiGLU ``mlp`` (``"dense"``) or a ``moe`` layer; none for ``"none"``."""
    if ffn == "none":
        return
    d = cfg.d_model
    block.ln2 = _pdict({"scale": (d,)}, device, dtype)
    if ffn == "moe":
        block.moe = MoEParams(cfg, device, dtype)
    elif ffn == "dense":
        block.mlp = _pdict({"wg": (d, cfg.d_ff), "wu": (d, cfg.d_ff), "wd": (cfg.d_ff, d)},
                           device, dtype)
    else:
        raise ValueError(f"unknown ffn {ffn!r}")


def _apply_ffn(block: nn.Module, cfg: ArchConfig, x: torch.Tensor, moe_impl: str):
    """``_apply_ffn`` of the reference: the residual FFN, if the layer has one."""
    if hasattr(block, "moe"):
        h = L.rmsnorm(block.ln2, x, cfg.norm_eps)
        return x + L.moe_layer(block.moe, cfg, h, impl=moe_impl)
    if hasattr(block, "mlp"):
        return x + L.mlp(block.mlp, L.rmsnorm(block.ln2, x, cfg.norm_eps))
    return x


class Block(nn.Module):
    """One pre-norm decoder (or encoder) layer: rmsnorm → attention (GQA, or
    MLA where the config has it) → rmsnorm → FFN (``ffn``: a SwiGLU
    ``"dense"`` or a ``"moe"`` layer)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16, ffn: str = "dense"):
        super().__init__()
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        if cfg.mla is not None:
            attn = L.mla_defs(cfg)
        else:
            attn = {"wq": (d, H, Dh), "wk": (d, KV, Dh), "wv": (d, KV, Dh), "wo": (H, Dh, d)}
            if cfg.qkv_bias:
                attn.update(bq=(H, Dh), bk=(KV, Dh), bv=(KV, Dh))
            if cfg.qk_norm:
                attn.update(q_norm=(Dh,), k_norm=(Dh,))
        self.ln1 = _pdict({"scale": (d,)}, device, dtype)
        self.attn = _pdict(attn, device, dtype)
        _add_ffn(self, cfg, ffn, device, dtype)

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str, moe_impl: str = "einsum"):
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
        return _apply_ffn(self, cfg, x + o, moe_impl)


class SSMBlock(nn.Module):
    """One pre-norm mamba2 layer: rmsnorm → SSD mixer, then the FFN a hybrid
    pattern gives the position (``ffn``: ``"none"`` in a pure SSM model, a
    SwiGLU ``"dense"`` or a ``"moe"`` layer in Jamba's ``super`` segment).
    ``dt_bias``, ``A_log`` and ``Dskip`` stay f32 whatever the model's
    dtype, as in the reference."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16, ffn: str = "none"):
        super().__init__()
        self.ln1 = _pdict({"scale": (cfg.d_model,)}, device, dtype)
        self.ssm = nn.ParameterDict({
            n: _param(shape, device, torch.float32 if n in S.F32_LEAVES else dtype)
            for n, shape in S.ssm_defs(cfg).items()})
        _add_ffn(self, cfg, ffn, device, dtype)

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str, moe_impl: str = "einsum"):
        o, _ = S.ssm_block(self.ssm, cfg, L.rmsnorm(self.ln1, x, cfg.norm_eps), cache, pos, mode)
        return _apply_ffn(self, cfg, x + o, moe_impl)


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
        d, V = cfg.d_model, cfg.vocab
        self.embed = _param((V, d), device, dtype)
        self.final_norm = _pdict({"scale": (d,)}, device, dtype)
        self.lm_head = None if cfg.tie_embeddings else _param((d, V), device, dtype)
        self.plan = layer_plan(cfg)
        self.layers = nn.ModuleList(
            (SSMBlock if slot.mixer == "ssm" else Block)(cfg, device, dtype, ffn=slot.ffn)
            for slot in self.plan)


def _default_scale(shape: Tuple[int, ...]) -> float:
    """``ParamDef.default_scale``: 1/sqrt(shape[-2]) (shape[-1] for vectors)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda", dtype=torch.bfloat16) -> Transformer:
    """Random weights drawn as the reference's ``ParamDef`` does: normals at
    ``default_scale`` (``embed`` at 0.02, ``conv_w`` at 1/conv_width), norm
    scales, ``kv_norm`` and ``Dskip`` at one, biases, ``dt_bias`` and
    ``A_log`` at zero.  ``default_scale`` takes ``shape[-2]`` as the fan-in,
    which for MLA's ``wq [d, H, nope+rope]`` and ``w_uk``/``w_uv [r, H, *]``
    is the head count, as in the reference.  The router and the SSM's f32
    leaves stay f32.
    The normals come from ``generator`` (drawn in f32 on its device, scaled
    in place, then cast: one f32 temporary of the largest leaf, 16.6 GiB for
    Arctic's experts), so they differ from ``jax.random``'s; tests that
    compare the two packages convert the reference's weights with
    ``params_from_numpy`` instead."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    for name, prm in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in _ONES:
            prm.fill_(1.0)
        elif leaf in _ZEROS:
            prm.zero_()
        else:
            if leaf == "embed":
                scale = _EMBED_SCALE
            elif leaf == "conv_w":
                scale = 1.0 / cfg.ssm.conv_width
            else:
                scale = _default_scale(tuple(prm.shape))
            # one f32 temporary, freed before the next leaf's draw
            prm.copy_(torch.randn(prm.shape, generator=generator,
                                  device=generator.device).mul_(scale))
    return model


def _cache_defs(cfg: ArchConfig, mixer: str, batch: int, max_seq: int,
                dtype) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """One layer's cache leaves (``cache_defs_for`` of the reference)."""
    if mixer == "ssm":
        return S.ssm_cache_defs(cfg, batch, dtype)
    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": ((batch, max_seq, m.kv_lora_rank), dtype),
                "k_rope": ((batch, max_seq, m.rope_head_dim), dtype)}
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": (shape, dtype), "v": (shape, dtype)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda", dtype=torch.bfloat16):
    """Zeroed cache in the reference's tree (``segments/<name>/p<j>``, each
    leaf stacked over the segment's repeats), with a scalar ``pos``: k/v or
    MLA's latent and rope key in ``dtype`` (bf16, ``ParamDef``'s default,
    whatever the params are), or the SSM's conv window in ``dtype`` and its
    state in f32.  ``max_seq`` is unused by an SSM."""
    dev = resolve_device(device)
    segs = {}
    for seg in segments(cfg):
        segs[seg["name"]] = {
            f"p{j}": {n: torch.zeros((seg["repeat"], *shape), dtype=dt, device=dev)
                      for n, (shape, dt) in _cache_defs(cfg, mixer, batch, max_seq,
                                                        dtype).items()}
            for j, (mixer, _ffn) in enumerate(seg["pattern"])}
    return {"segments": segs, "pos": torch.zeros((), dtype=torch.int64, device=dev)}


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
    x = _embed(params, inputs)
    x = _run_layers(params, cfg, x, cache if mode == "prefill" else None, None, mode, moe_impl,
                    remat)
    logits = _unembed(params, cfg, x)
    if mode == "prefill":
        cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int64, device=x.device)
        return logits, cache
    return logits


def decode_step(params: Transformer, cfg: ArchConfig, cache, tokens: torch.Tensor,
                moe_impl: str = "einsum"):
    """One decode step: tokens [B,1] -> (logits [B,1,V], cache updated in place)."""
    x = params.embed[tokens]
    pos = cache["pos"]
    x = _run_layers(params, cfg, x, cache, pos, "decode", moe_impl)
    logits = _unembed(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache
