"""Building blocks of the dense LM: norms, rope, GQA attention, SwiGLU.

Port of the dense-path part of ``repro/models/layers.py``.  Functions take a
parameter mapping ``p`` (an ``nn.ParameterDict`` of the model, or any dict
of tensors) and tensors in the reference's layouts (``[B, S, H, D]``), so
the parity tests compare like with like.  Where the reference computes
attention with ``chunked_attention`` over the whole sequence (train and
prefill), the port calls the CUDA flash-attention kernel through
``ops.gqa_flash_attention``; the MLP goes through the fused SwiGLU kernel.
Decode attention stays the plain ``chunked_attention``, as in the
reference.

Cache writes happen in place: the cache tensors passed in are updated and
returned, where the reference returns new arrays.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ops import fused_swiglu, gqa_flash_attention

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


def attention_full(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Train/prefill attention over the whole sequence (no cache returned)."""
    q, k, v = attention_qkv(p, cfg, x, _prompt_positions(x))
    return _out_proj(p, gqa_flash_attention(q, k, v, causal=cfg.causal))


def attention_prefill(p: Params, cfg: ArchConfig, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor]):
    """Prefill: full attention over the unrounded k/v; k/v written into the
    cache (in the cache's dtype) at positions [0, S)."""
    S = x.shape[1]
    q, k, v = attention_qkv(p, cfg, x, _prompt_positions(x))
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return _out_proj(p, gqa_flash_attention(q, k, v, causal=cfg.causal)), cache


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
# SwiGLU MLP
# --------------------------------------------------------------------------- #
def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wu) @ wd``: the gate/up products and the
    epilogue in the fused kernel, the down projection a plain matmul."""
    return fused_swiglu(x, p["wg"], p["wu"]) @ p["wd"]
