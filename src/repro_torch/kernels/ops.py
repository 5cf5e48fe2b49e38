"""Model-facing wrappers around the port's kernels.

Port of ``repro/kernels/ops.py``: they adapt model-layout tensors (GQA head
grouping, ``[B, S, H, D]``) to the attention kernel's flat ``[BH, S, D]``
layout and pad attention and SwiGLU operands as the reference does (the
port's own non-causal entry, :func:`gqa_bidirectional_attention`, pads
nothing); the SSM
mixer's ``ssd_mixer`` lives with its kernel (``kernels/ssd_scan.py``),
which reads the model's own layout, and the MoE layer's expert products go
to ``swiglu_experts`` as they are (``[E, M, D]``: the reference computes
them with einsums, not a blocked kernel, so nothing is padded).  The same call sites work on the CPU
(plain versions) and on the card (the CUDA kernels).  There is no switch
and no fallback: the device of the tensors decides.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_mixer
from repro_torch.kernels.swiglu_matmul import swiglu_experts, swiglu_matmul

__all__ = ["gqa_flash_attention", "gqa_bidirectional_attention", "ssd_mixer", "fused_swiglu",
           "swiglu_experts"]


def _flat_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """[B, S, H, D] q and [B, S, KV, D] k/v (KV repeated per query group) as
    the kernel's flat ``[B·H, S, D]``."""
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    if G != 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    return tuple(t.movedim(2, 1).reshape(B * H, S, t.shape[-1]) for t in (q, k, v))


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # F.pad lists the last dim first
    return F.pad(x, widths)


def gqa_flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, Dv]
    causal: bool = True,
    block_q: int = 256,
    block_k: int = 256,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """GQA wrapper: repeats KV per query group, flattens heads into batch.
    Returns [B, S, H, Dv]; ``scale`` defaults to D^-0.5."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    qf, kf, vf = _flat_heads(q, k, v)
    bq = min(block_q, max(8, S))
    bk = min(block_k, max(8, S))
    qf = _pad_to(qf, 1, bq).contiguous()
    kf = _pad_to(kf, 1, bk).contiguous()
    vf = _pad_to(vf, 1, bk).contiguous()
    # padded KV rows are masked out by causality (they sit beyond every q
    # row); as in the reference, the call is causal whatever ``causal`` says
    o = flash_attention(qf, kf, vf, causal=True if not causal else causal, scale=scale)
    o = o[:, :S].reshape(B, H, S, Dv)
    return o.movedim(1, 2)


def gqa_bidirectional_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, Dv]
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Non-causal GQA attention (an encoder's): every query attends to every
    key.  :func:`gqa_flash_attention` keeps the reference wrapper's quirk
    (causal whatever it is given) and pads K/V with zero rows that only
    causality hides; the reference's model never calls that wrapper for a
    non-causal config (it runs ``chunked_attention(causal=cfg.causal)``), so
    the port's model calls this one: the kernel with ``causal=False`` on
    the unpadded operands, whose ragged ends it masks itself.  Returns
    [B, S, H, Dv]; ``scale`` defaults to D^-0.5."""
    B, S, H, _ = q.shape
    qf, kf, vf = (t.contiguous() for t in _flat_heads(q, k, v))
    o = flash_attention(qf, kf, vf, causal=False, scale=scale)
    return o.reshape(B, H, S, v.shape[-1]).movedim(1, 2)


def fused_swiglu(
    x: torch.Tensor,   # [..., D]
    wg: torch.Tensor,  # [D, F]
    wu: torch.Tensor,  # [D, F]
    block_m: int = 256,
) -> torch.Tensor:
    """``silu(x @ wg) * (x @ wu)`` over the flattened leading dims; pads only M."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    Fd = wg.shape[1]
    xf = x.reshape(-1, D)
    M = xf.shape[0]
    bm = min(block_m, M)
    xf = _pad_to(xf, 0, bm).contiguous()
    o = swiglu_matmul(xf, wg, wu)
    return o[:M].reshape(*lead, Fd)
