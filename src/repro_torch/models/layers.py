"""Building blocks of the LMs: norms, rope, GQA and MLA attention, SwiGLU, MoE.

Port of ``repro/models/layers.py``.  Functions take a parameter mapping
``p`` (an ``nn.ParameterDict`` of the model, or any dict of tensors) and
tensors in the reference's layouts (``[B, S, H, D]``), so the parity tests
compare like with like.  Where the reference computes attention with
``chunked_attention`` over the whole sequence (train and prefill, GQA and
MLA), the port calls the CUDA flash-attention kernel through
``ops.gqa_flash_attention`` (causal) or ``ops.gqa_bidirectional_attention``
(an encoder's); every SwiGLU MLP (dense, shared experts, dense
residual) goes through the fused SwiGLU kernel, and the routed experts'
gate/up products through its expert-batched form.  Decode attention stays
plain torch, as in the reference: ``chunked_attention`` for GQA, the
absorbed latent products for MLA.  ``constrain`` (mesh hints) has no
counterpart on one card.

The ``*_defs`` functions return the reference's trees of
:class:`~repro_torch.parallel.sharding.ParamDef` (shape, logical axes,
dtype, initializer), from which ``models/transformer.py`` builds the
parameters.

Cache writes happen in place: the cache tensors passed in are updated and
returned, where the reference returns new arrays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.kernels.ops import (
    fused_swiglu, gqa_bidirectional_attention, gqa_flash_attention, swiglu_experts,
)
from repro_torch.parallel.sharding import ParamDef
from repro_torch.runtime import spans

F32 = torch.float32
NEG_INF = -1e30  # finite, as in the reference: a fully masked row stays finite

Params = Dict[str, torch.Tensor]
Pos = Union[int, torch.Tensor]


def f32_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 operands with f32 accumulation (the reference's ``mxu_einsum``):
    both operands are cast to f32, which is exact for bf16."""
    return torch.einsum(spec, a.to(F32), b.to(F32))


# --------------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------------- #
def rmsnorm_defs(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), ("embed",), init="ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(F32)).to(x.dtype)


def head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qk-norm: rmsnorm over the head_dim axis (qwen3)."""
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(F32)).to(x.dtype)


# --------------------------------------------------------------------------- #
# rotary embeddings
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: [..., S] (broadcastable).  Rotates the
    two halves of D (not interleaved pairs), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # [D/2]
    ang = positions[..., :, None, None].to(F32) * freqs  # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- #
# chunked attention — plain torch, used by decode
# --------------------------------------------------------------------------- #
def chunked_attention(
    q: torch.Tensor,          # [B, Sq, H, D]
    k: torch.Tensor,          # [B, Sk, KV, D]
    v: torch.Tensor,          # [B, Sk, KV, Dv]
    causal: bool,
    q_chunk: int = 1024,
    q_offset: int = 0,        # absolute position of q[0] (prefill continuation)
    kv_len: Optional[Pos] = None,  # valid k/v prefix: scalar or [B] (decode)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Numerically stable attention, one query chunk at a time.

    Peak memory is [B, q_chunk, KV, G, Sk]; GQA folds the query-head group
    into the einsum.  Probabilities are rounded to ``v.dtype`` before the
    P·V product and the output is ``v.dtype``, as in the reference.
    """
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    sc = scale if scale is not None else D ** -0.5
    q = q.reshape(B, Sq, KV, G, D)
    kpos = torch.arange(Sk, device=q.device)
    if kv_len is not None:
        klen = torch.as_tensor(kv_len, device=q.device)
        if klen.ndim == 0:
            len_mask = (kpos < klen)[None, None, None, None, :]
        else:  # per-sequence lengths [B]
            len_mask = (kpos[None, :] < klen[:, None])[:, None, None, None, :]
    q_chunk = min(q_chunk, Sq)
    outs = []
    for c0 in range(0, Sq, q_chunk):
        qi = q[:, c0:c0 + q_chunk]  # [B, C, KV, G, D]
        s = f32_einsum("bckgd,bskd->bckgs", qi, k) * sc
        if causal:
            qpos = q_offset + c0 + torch.arange(qi.shape[1], device=q.device)
            mask = kpos[None, :] <= qpos[:, None]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        if kv_len is not None:
            s = torch.where(len_mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        outs.append(f32_einsum("bckgs,bskd->bckgd", p, v).to(v.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv)


# --------------------------------------------------------------------------- #
# GQA attention
# --------------------------------------------------------------------------- #
def attention_defs(cfg: ArchConfig) -> Dict[str, Any]:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # "qk" (head_dim) is the TP fallback axis: GQA head counts (40, 56, 14…)
    # rarely divide a 16-way model axis, head_dim=128 always does.  The rules
    # decide which of heads/qk actually binds per policy + divisibility.
    out: Dict[str, Any] = {
        "wq": ParamDef((d, H, Dh), ("embed", "heads", "qk")),
        "wk": ParamDef((d, KV, Dh), ("embed", "kv_heads", "qk")),
        "wv": ParamDef((d, KV, Dh), ("embed", "kv_heads", "qk")),
        "wo": ParamDef((H, Dh, d), ("heads", "qk", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((H, Dh), ("heads", None), init="zeros")
        out["bk"] = ParamDef((KV, Dh), ("kv_heads", None), init="zeros")
        out["bv"] = ParamDef((KV, Dh), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        out["q_norm"] = ParamDef((Dh,), (None,), init="ones")
        out["k_norm"] = ParamDef((Dh,), (None,), init="ones")
    return out


def attention_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm:
        q = head_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = head_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if cfg.rope_theta is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: Params, o: torch.Tensor) -> torch.Tensor:
    # the reference's einsum promotes a bf16 ``o`` to the weights' dtype
    return torch.einsum("bshk,hkd->bsd", o.to(p["wo"].dtype), p["wo"])


def _prompt_positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _attend(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Whole-sequence attention as the reference's ``chunked_attention(...,
    causal=cfg.causal)``: a decoder's through ``gqa_flash_attention``, an
    encoder's (HuBERT) through the non-causal entry (that wrapper is causal
    whatever it is given, as the reference's wrapper is)."""
    if cfg.causal:
        return gqa_flash_attention(q, k, v, causal=True)
    return gqa_bidirectional_attention(q, k, v)


def attention_full(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill attention over the whole sequence (no cache returned)."""
    q, k, v = attention_qkv(p, cfg, x, _prompt_positions(x))
    return _out_proj(p, _attend(cfg, q, k, v))


def attention_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor]):
    """Prefill: full attention over the unrounded k/v; k/v written into the
    cache (in the cache's dtype) at positions [0, S)."""
    S = x.shape[1]
    q, k, v = attention_qkv(p, cfg, x, _prompt_positions(x))
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _out_proj(p, _attend(cfg, q, k, v)), cache


def cache_write(arr: torch.Tensor, val: torch.Tensor, pos: Pos) -> torch.Tensor:
    """Write the step-token entry ``val[:, 0]`` at position ``pos`` (scalar or
    per-sequence [B] vector) of a [B, Smax, ...] cache array, in place.

    Out-of-range positions behave as in the reference: a scalar position is
    clamped to the last entry (``dynamic_update_slice``), and a row whose
    vector position is past the end is left as it was (a dropped
    ``.at[].set``).  Both are done on the device, with no host sync.
    """
    Smax = arr.shape[1]
    pos = torch.as_tensor(pos, device=arr.device)
    new = val[:, 0].to(arr.dtype)
    if pos.ndim == 0:
        arr.index_copy_(1, pos.clamp(0, Smax - 1).reshape(1), new[:, None])
        return arr
    rows = torch.arange(arr.shape[0], device=arr.device)
    safe = pos.clamp(0, Smax - 1)
    keep = (pos >= Smax).view(-1, *([1] * (new.ndim - 1)))
    arr[rows, safe] = torch.where(keep, arr[rows, safe], new)
    return arr


def _decode_positions(pos: torch.Tensor, batch: int) -> torch.Tensor:
    if pos.ndim == 0:
        return pos.expand(batch, 1)
    return pos[:, None]


def attention_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: Pos):
    """One-token decode against a [B, Smax, KV, D] cache, updated in place.

    ``pos`` may be a scalar (lockstep batch) or a per-sequence [B] vector
    (continuous batching with ragged slot positions).
    """
    pos = torch.as_tensor(pos, device=x.device)
    q, k, v = attention_qkv(p, cfg, x, _decode_positions(pos, x.shape[0]))
    ck = cache_write(cache["k"], k, pos)
    cv = cache_write(cache["v"], v, pos)
    o = chunked_attention(q, ck, cv, causal=False, q_chunk=1, kv_len=pos + 1)
    return _out_proj(p, o), cache


# --------------------------------------------------------------------------- #
# MLA attention (DeepSeek-V2): latent-compressed KV
# --------------------------------------------------------------------------- #
def mla_defs(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    dq = m.nope_head_dim + m.rope_head_dim
    out: Dict[str, Any] = {
        # queries (V2-Lite: full-rank)
        "wq": ParamDef((d, H, dq), ("embed", "heads", None)),
        # joint KV down-projection -> latent + decoupled rope key
        "w_dkv": ParamDef((d, m.kv_lora_rank + m.rope_head_dim), ("embed", None)),
        "kv_norm": ParamDef((m.kv_lora_rank,), (None,), init="ones"),
        # up-projections from the latent
        "w_uk": ParamDef((m.kv_lora_rank, H, m.nope_head_dim), (None, "heads", None)),
        "w_uv": ParamDef((m.kv_lora_rank, H, m.v_head_dim), (None, "heads", None)),
        "wo": ParamDef((H, m.v_head_dim, d), ("heads", None, "embed")),
    }
    return out


def _mla_latent(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv, k_rope = dkv[..., :m.kv_lora_rank], dkv[..., m.kv_lora_rank:]
    c_kv = rmsnorm({"scale": p["kv_norm"]}, c_kv, cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta or 1e4)
    return c_kv, k_rope[:, :, 0, :]


def _mla_queries(p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta or 1e4)


def _mla_scale(cfg: ArchConfig) -> float:
    return (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** -0.5


def _mla_attend(p: Params, cfg: ArchConfig, x: torch.Tensor, c_kv: torch.Tensor,
                k_rope: torch.Tensor) -> torch.Tensor:
    """Per-head K/V expanded from the latent, the rope key broadcast to every
    head as the reference concatenates it: q/k [B, S, H, nope + rope], v [B,
    S, H, v_head_dim], through the flash kernel at scale (nope + rope)^-0.5."""
    q_nope, q_rope = _mla_queries(p, cfg, x, _prompt_positions(x))
    k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
    vv = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(*k_nope.shape[:3], k_rope.shape[-1])],
                  dim=-1)
    o = gqa_flash_attention(q, k, vv, causal=cfg.causal, scale=_mla_scale(cfg))
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def mla_attention_full(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill MLA over the whole sequence (no cache returned)."""
    c_kv, k_rope = _mla_latent(p, cfg, x, _prompt_positions(x))
    return _mla_attend(p, cfg, x, c_kv, k_rope)


def mla_attention_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                          cache: Dict[str, torch.Tensor]):
    """Prefill: attention as :func:`mla_attention_full`; the latent and the
    rope key written into the cache (in its dtype) at positions [0, S).  The
    reference computes the latent twice (once here, once in its full
    attention); the values are the same, so the port computes it once."""
    S = x.shape[1]
    c_kv, k_rope = _mla_latent(p, cfg, x, _prompt_positions(x))
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :S] = k_rope.to(cache["k_rope"].dtype)
    return _mla_attend(p, cfg, x, c_kv, k_rope), cache


def mla_attention_decode(p: Params, cfg: ArchConfig, x: torch.Tensor,
                         cache: Dict[str, torch.Tensor], pos: Pos):
    """Absorbed-matmul decode against the [B, Smax, r] latent and [B, Smax,
    rope] key caches, updated in place: q_c = q_nope·W_ukᵀ, scores over the
    latent plus the rope key, o_c = probs·c_kv, out = o_c·W_uv·W_o.  The
    products the reference runs through ``mxu_einsum`` accumulate in f32
    here (:func:`f32_einsum`); the probabilities are rounded to the cache's
    dtype, as there.  ``pos``: scalar or per-slot [B]."""
    pos = torch.as_tensor(pos, device=x.device)
    positions = _decode_positions(pos, x.shape[0])
    c_new, kr_new = _mla_latent(p, cfg, x, positions)
    c_all = cache_write(cache["c_kv"], c_new, pos)
    kr_all = cache_write(cache["k_rope"], kr_new, pos)
    q_nope, q_rope = _mla_queries(p, cfg, x, positions)
    q_c = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])  # absorb W_uk
    s = (f32_einsum("bshr,btr->bhst", q_c, c_all)
         + f32_einsum("bshk,btk->bhst", q_rope, kr_all)) * _mla_scale(cfg)
    kpos = torch.arange(c_all.shape[1], device=x.device)
    limit = pos if pos.ndim == 0 else pos[:, None, None, None]
    s = torch.where(kpos[None, None, None, :] <= limit, s, NEG_INF)
    prob = torch.softmax(s, dim=-1).to(c_all.dtype)
    o_c = f32_einsum("bhst,btr->bshr", prob, c_all).to(x.dtype)
    o = torch.einsum("bshr,rhk->bshk", o_c, p["w_uv"])
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), cache


# --------------------------------------------------------------------------- #
# SwiGLU MLP
# --------------------------------------------------------------------------- #
def mlp_defs(d: int, f: int) -> Dict[str, ParamDef]:
    return {
        "wg": ParamDef((d, f), ("embed", "ffn")),
        "wu": ParamDef((d, f), ("embed", "ffn")),
        "wd": ParamDef((f, d), ("ffn", "embed")),
    }


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wu) @ wd``: the gate/up products and the
    epilogue in the fused kernel, the down projection a plain matmul."""
    return fused_swiglu(x, p["wg"], p["wu"]) @ p["wd"]


# --------------------------------------------------------------------------- #
# Mixture of Experts
# --------------------------------------------------------------------------- #
def moe_defs(cfg: ArchConfig) -> Dict[str, Any]:
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.n_experts
    # expert weights use dedicated logical axes (§Perf i5): `expert_ffn`
    # maps to `data` as a TENSOR-parallel dim (activation psums), never the
    # FSDP gather path — 480B of expert weights must stay resident, not be
    # re-gathered every microbatch (was 38 s/step of all-gather for arctic)
    out: Dict[str, Any] = {
        "router": ParamDef((d, E), ("embed", "experts"), dtype=torch.float32),
        "wg": ParamDef((E, d, f), ("experts", "expert_embed", "expert_ffn")),
        "wu": ParamDef((E, d, f), ("experts", "expert_embed", "expert_ffn")),
        "wd": ParamDef((E, f, d), ("experts", "expert_ffn", "expert_embed")),
    }
    if m.n_shared:
        out["shared"] = mlp_defs(d, m.n_shared * f)
    if m.dense_residual:
        out["residual"] = mlp_defs(d, cfg.d_ff)
    return out


def moe_capacity(m: MoESpec, s: int) -> int:
    """Slots an expert has in a group of ``s`` tokens:
    ceil(top_k·s/E·capacity_factor), at least 1."""
    return max(1, int(m.top_k * s / m.n_experts * m.capacity_factor + 0.999))


def moe_route(p: Params, m: MoESpec, xc: torch.Tensor):
    """Top-k routing of xc [G, s, D]: the renormalised gate weights and
    expert indices [G, s, K] (softmax over the f32 router logits)."""
    gates = torch.softmax(torch.einsum("gsd,de->gse", xc.to(F32), p["router"].to(F32)), dim=-1)
    gate_k, idx_k = torch.topk(gates, m.top_k, dim=-1)
    return gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9), idx_k


def expert_arrivals(chosen: torch.Tensor) -> torch.Tensor:
    """chosen [G, s, E] (1 where token s picked expert e): how many tokens up
    to and including s picked e.  A token picks an expert at most once, so
    this is the reference's running count over the (s, k) choices in
    token-major order.  Scanned along the innermost dim (E rows of s): a
    scan along dim 1 of [G, s·K, E] ran PyTorch's outer-dim scan kernel, ~1
    ms a layer at s = 1024 on the H100 (PERF.md)."""
    return torch.cumsum(chosen.transpose(1, 2).contiguous(), dim=-1).transpose(1, 2)


def expert_products(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their inputs xe [E, M, D]: gate/up through
    the expert-batched kernel, the down projection a batched matmul."""
    return torch.bmm(swiglu_experts(xe, p["wg"], p["wu"]), p["wd"])


def moe_tally(tally: Optional[tuple], m: MoESpec, C: int, kept: torch.Tensor) -> None:
    """Count one dispatch where ``tally`` = (phase, tokens of each sequence)
    is given: ``moe.rows.<phase>`` the expert rows computed (E·G·C),
    ``moe.routed.<phase>`` the top-k choices of real tokens and
    ``moe.kept.<phase>`` (on the device) those that got a capacity slot.
    kept [G, s]: each token's choices that got a slot; a sequence's groups
    are consecutive, its padding last in its last group."""
    if tally is None:
        return
    phase, S = tally
    G, s = kept.shape
    groups = -(-S // s)
    B = G // groups
    spans.count(f"moe.rows.{phase}", m.n_experts * G * C)
    spans.count(f"moe.routed.{phase}", B * S * m.top_k)
    spans.count_device(f"moe.kept.{phase}", kept.reshape(B, groups * s)[:, :S].sum())


def _moe_chunk_einsum(p: Params, m: MoESpec, xc: torch.Tensor,
                      tally: Optional[tuple] = None) -> torch.Tensor:
    """GShard per-group one-hot dispatch: xc [G, s, D] -> [G, s, D].

    Capacity C = ceil(top_k·s/E·capacity_factor) per group; a token's k-th
    choice takes the next free slot of its expert in token-major order, and
    overflow is dropped (combine weight zero), as in the reference.  A token
    picks an expert at most once, so the reference's [G, s, K, E, C] one-hot
    summed over K is built here directly as [G, s, E, C].  The experts see
    [E, G·C, D]: the groups fold into each expert's rows.  ``tally``: see
    :func:`moe_tally`."""
    G, s, D = xc.shape
    E, C = m.n_experts, moe_capacity(m, s)
    with spans.span("model.moe.route"):
        gate_k, idx_k = moe_route(p, m, xc)
    with spans.span("model.moe.dispatch"):
        onehot = F.one_hot(idx_k, E).to(F32)                          # [G, s, K, E]
        chosen = onehot.sum(2)                                        # [G, s, E]: 0 or 1
        pos = expert_arrivals(chosen) * chosen - 1.0                  # [G, s, E]; -1: not chosen
        gate = (onehot * gate_k[..., None]).sum(2)                    # [G, s, E]
        disp = (pos[..., None] == torch.arange(C, device=xc.device, dtype=F32))  # [G, s, E, C]
        comb = disp * gate[..., None]
        xe = torch.einsum("gsec,gsd->egcd", disp.to(xc.dtype), xc).reshape(E, G * C, D)
        xe = xe.contiguous()
        if tally is not None:
            moe_tally(tally, m, C, ((pos >= 0) & (pos < C)).sum(-1))
    with spans.span("model.moe.experts"):
        ye = expert_products(p, xe).reshape(E, G, C, D)
    with spans.span("model.moe.combine"):
        return torch.einsum("gsec,egcd->gsd", comb.to(xc.dtype), ye)


def moe_layer(p: Params, cfg: ArchConfig, x: torch.Tensor, impl: str = "einsum",
              mode: str = "train") -> torch.Tensor:
    """Routed experts over chunks of ``router_chunk`` tokens, plus the shared
    experts and the dense residual where the config has them.

    The reference scans the chunks with no carry; here every chunk of every
    sequence is one group of a single call (G = B·n_chunks), which gives the
    same values.  Padding sits last in the last chunk, so it never takes a
    slot before a real token.  While spans record, a ``"prefill"`` or
    ``"decode"`` ``mode`` counts the dispatch (:func:`moe_tally`)."""
    m = cfg.moe
    B, S, D = x.shape
    chunk = min(m.router_chunk, S)
    pad = (-S) % chunk
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    if impl == "einsum":
        fn = _moe_chunk_einsum
    elif impl == "scatter":
        from repro_torch.models.moe_scatter import moe_chunk_scatter as fn
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    tally = (mode, S) if mode in ("prefill", "decode") and spans.active() else None
    y = fn(p, m, xp.reshape(-1, chunk, D), tally).reshape(B, S + pad, D)[:, :S]
    if m.n_shared:
        y = y + mlp(p["shared"], x)
    if m.dense_residual:
        y = y + mlp(p["residual"], x)
    return y
