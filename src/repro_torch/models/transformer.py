"""Decoder-only LMs (dense and SSM): parameters, cache and the three entry points.

Port of the ``dense`` and ``ssm`` segments of ``repro/models/transformer.py``.
The reference stacks the layers' parameters under ``segments/<name>/p0`` and
runs them with ``lax.scan``; here each layer is a :class:`Block` (attention
and SwiGLU) or an :class:`SSMBlock` (a mamba2 mixer, no FFN) in an
``nn.ModuleList``, and the scan is a Python loop.  The cache keeps the
reference's tree and layer-stacked layouts (``[L, B, Smax, KV, D]`` k/v;
``[L, B, w-1, CH]`` conv window and ``[L, B, H, P, N]`` state), and is
updated in place.  ``constrain`` (mesh sharding hints) has no counterpart on
one card.

Three entry points share parameters:

* ``forward(..., mode="train")``   — full-sequence logits.
* ``forward(..., mode="prefill")`` — logits + populated cache.
* ``decode_step``                   — one token against the cache.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

__all__ = ["Transformer", "Block", "SSMBlock", "segment_name", "init_params", "init_cache",
           "forward", "decode_step"]

# parameter leaves by initializer (``ParamDef.init`` in the reference)
_ONES = {"scale", "q_norm", "k_norm", "Dskip", "norm"}
_ZEROS = {"bq", "bk", "bv", "dt_bias", "A_log", "conv_b"}
_EMBED_SCALE = 0.02


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for configs outside this slice."""
    todo = (
        (cfg.hybrid is not None,
         "hybrid SSM/attention models (with the super segment) are not ported yet"),
        (cfg.moe is not None, "MoE models are not ported yet"),
        (cfg.mla is not None, "MLA attention is not ported yet"),
        (cfg.frontend is not None or not cfg.causal,
         "audio/vision frontends and encoder-only models are not ported yet"),
    )
    for hit, what in todo:
        if hit:
            raise NotImplementedError(
                f"{cfg.name}: {what} (ROADMAP Queue 1, item 8: MoE, MLA and frontend serving)")


def _param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _pdict(shapes: Dict[str, Tuple[int, ...]], device, dtype) -> nn.ParameterDict:
    return nn.ParameterDict({n: _param(s, device, dtype) for n, s in shapes.items()})


class Block(nn.Module):
    """One pre-norm decoder layer: rmsnorm → GQA attention → rmsnorm → SwiGLU."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        attn = {"wq": (d, H, Dh), "wk": (d, KV, Dh), "wv": (d, KV, Dh), "wo": (H, Dh, d)}
        if cfg.qkv_bias:
            attn.update(bq=(H, Dh), bk=(KV, Dh), bv=(KV, Dh))
        if cfg.qk_norm:
            attn.update(q_norm=(Dh,), k_norm=(Dh,))
        self.ln1 = _pdict({"scale": (d,)}, device, dtype)
        self.attn = _pdict(attn, device, dtype)
        self.ln2 = _pdict({"scale": (d,)}, device, dtype)
        self.mlp = _pdict({"wg": (d, cfg.d_ff), "wu": (d, cfg.d_ff), "wd": (cfg.d_ff, d)},
                          device, dtype)

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str):
        h = L.rmsnorm(self.ln1, x, cfg.norm_eps)
        if mode == "decode":
            o, _ = L.attention_decode(self.attn, cfg, h, cache, pos)
        elif mode == "prefill":
            o, _ = L.attention_prefill(self.attn, cfg, h, cache)
        else:
            o = L.attention_full(self.attn, cfg, h)
        x = x + o
        h = L.rmsnorm(self.ln2, x, cfg.norm_eps)
        return x + L.mlp(self.mlp, h)


class SSMBlock(nn.Module):
    """One pre-norm mamba2 layer: rmsnorm → SSD mixer (no FFN).  ``dt_bias``,
    ``A_log`` and ``Dskip`` stay f32 whatever the model's dtype, as in the
    reference."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.ln1 = _pdict({"scale": (cfg.d_model,)}, device, dtype)
        self.ssm = nn.ParameterDict({
            n: _param(shape, device, torch.float32 if n in S.F32_LEAVES else dtype)
            for n, shape in S.ssm_defs(cfg).items()})

    def forward(self, cfg: ArchConfig, x, cache, pos, mode: str):
        o, _ = S.ssm_block(self.ssm, cfg, L.rmsnorm(self.ln1, x, cfg.norm_eps), cache, pos, mode)
        return x + o


def segment_name(cfg: ArchConfig) -> str:
    """The reference's one segment for this config: its layers' parameters
    and cache sit under ``segments/<name>/p0``."""
    return "ssm" if cfg.family == "ssm" else "dense"


class Transformer(nn.Module):
    """Parameters of a dense or SSM LM (``model_defs`` of the reference) on one device."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=torch.bfloat16):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, V = cfg.d_model, cfg.vocab
        self.embed = _param((V, d), device, dtype)
        self.final_norm = _pdict({"scale": (d,)}, device, dtype)
        self.lm_head = None if cfg.tie_embeddings else _param((d, V), device, dtype)
        block = SSMBlock if segment_name(cfg) == "ssm" else Block
        self.layers = nn.ModuleList(block(cfg, device, dtype) for _ in range(cfg.n_layers))


def _default_scale(shape: Tuple[int, ...]) -> float:
    """``ParamDef.default_scale``: 1/sqrt(shape[-2]) (shape[-1] for vectors)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device: DeviceLike = "cuda", dtype=torch.bfloat16) -> Transformer:
    """Random weights drawn as the reference's ``ParamDef`` does: normals at
    ``default_scale`` (``embed`` at 0.02, ``conv_w`` at 1/conv_width), norm
    scales and ``Dskip`` at one, biases, ``dt_bias`` and ``A_log`` at zero.
    The normals come from ``generator`` (drawn in f32 on its device, then cast),
    so they differ from ``jax.random``'s; tests that compare the two packages
    convert the reference's weights with ``params_from_numpy`` instead."""
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
            draw = torch.randn(prm.shape, generator=generator, device=generator.device)
            prm.copy_(draw * scale)
    return model


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               device: DeviceLike = "cuda", dtype=torch.bfloat16):
    """Zeroed cache in the reference's tree, with a scalar ``pos``: k/v in
    ``dtype`` (bf16, ``ParamDef``'s default, whatever the params are), or the
    SSM's conv window in ``dtype`` and its state in f32.  ``max_seq`` is
    unused by an SSM."""
    dev = resolve_device(device)
    seg = segment_name(cfg)
    if seg == "ssm":
        p0 = {n: torch.zeros((cfg.n_layers, *shape), dtype=dt, device=dev)
              for n, (shape, dt) in S.ssm_cache_defs(cfg, batch, dtype).items()}
    else:
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        p0 = {"k": torch.zeros(shape, dtype=dtype, device=dev),
              "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return {"segments": {seg: {"p0": p0}},
            "pos": torch.zeros((), dtype=torch.int64, device=dev)}


def _unembed(params: Transformer, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, params.embed)
    return torch.einsum("bsd,dv->bsv", x, params.lm_head)


def _run_layers(params: Transformer, cfg: ArchConfig, x, cache, pos, mode: str):
    leaves = cache["segments"][segment_name(cfg)]["p0"] if cache is not None else None
    for i, block in enumerate(params.layers):
        layer_cache = {n: t[i] for n, t in leaves.items()} if leaves is not None else None
        x = block(cfg, x, layer_cache, pos, mode)
    return x


def forward(params: Transformer, cfg: ArchConfig, inputs: Dict[str, torch.Tensor],
            mode: str = "train", cache=None):
    """inputs: {tokens: [B,S] int} (``embeds`` come with the frontend slice).

    mode="train": returns logits.  mode="prefill": returns (logits, cache);
    ``cache`` must be a fresh ``init_cache`` tree, and is filled in place.
    """
    if mode not in ("train", "prefill"):
        raise ValueError(f"unknown mode {mode!r}")
    x = params.embed[inputs["tokens"]]
    x = _run_layers(params, cfg, x, cache if mode == "prefill" else None, None, mode)
    logits = _unembed(params, cfg, x)
    if mode == "prefill":
        cache["pos"] = torch.tensor(x.shape[1], dtype=torch.int64, device=x.device)
        return logits, cache
    return logits


def decode_step(params: Transformer, cfg: ArchConfig, cache, tokens: torch.Tensor):
    """One decode step: tokens [B,1] -> (logits [B,1,V], cache updated in place)."""
    x = params.embed[tokens]
    pos = cache["pos"]
    x = _run_layers(params, cfg, x, cache, pos, "decode")
    logits = _unembed(params, cfg, x)
    cache["pos"] = pos + 1
    return logits, cache
