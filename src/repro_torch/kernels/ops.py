"""Model-facing wrappers around the port's kernels.

Port of ``repro/kernels/ops.py``: they adapt model-layout tensors (GQA head
grouping, SSM group broadcast, ``[B, S, H, D]``) to the kernels' flat
``[BH, S, D]`` layout and pad attention and SwiGLU operands as the reference
does, so the same call sites work on the CPU
(plain versions) and on the card (the CUDA kernels).  There is no switch
and no fallback: the device of the tensors decides.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.swiglu_matmul import swiglu_matmul

__all__ = ["gqa_flash_attention", "ssd_mixer", "fused_swiglu"]


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]  # F.pad lists the last dim first
    return F.pad(x, widths)


def gqa_flash_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, KV, D]
    v: torch.Tensor,  # [B, S, KV, D]
    causal: bool = True,
    block_q: int = 256,
    block_k: int = 256,
) -> torch.Tensor:
    """GQA wrapper: repeats KV per query group, flattens heads into batch."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    if G != 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    bq = min(block_q, max(8, S))
    bk = min(block_k, max(8, S))
    qf = _pad_to(q.movedim(2, 1).reshape(B * H, S, D), 1, bq).contiguous()
    kf = _pad_to(k.movedim(2, 1).reshape(B * H, S, D), 1, bk).contiguous()
    vf = _pad_to(v.movedim(2, 1).reshape(B * H, S, D), 1, bk).contiguous()
    # padded KV rows are masked out by causality (they sit beyond every q
    # row); as in the reference, the call is causal whatever ``causal`` says
    o = flash_attention(qf, kf, vf, causal=True if not causal else causal)
    o = o[:, :S].reshape(B, H, S, D)
    return o.movedim(1, 2)


def ssd_mixer(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    A: torch.Tensor,   # [H]
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    return_state: bool = False,
):
    """Model-layout wrapper: broadcast groups to heads and flatten [B*H].
    Unlike the reference it does not pad S to its block: the kernel masks a
    ragged end itself.  Returns y [B, S, H, P]; with ``return_state`` also
    the final state [B, H, P, N] (f32), which the reference's ``ssm_block``
    takes from ``_ssd_chunked``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if rep != 1:
        Bm = Bm.repeat_interleave(rep, dim=2)
        Cm = Cm.repeat_interleave(rep, dim=2)
    xf = x.movedim(2, 1).reshape(B * H, S, P).contiguous()
    dtf = dt.movedim(2, 1).reshape(B * H, S).to(torch.float32).contiguous()
    Bf = Bm.movedim(2, 1).reshape(B * H, S, N).contiguous()
    Cf = Cm.movedim(2, 1).reshape(B * H, S, N).contiguous()
    Af = A.to(torch.float32).repeat(B)
    out = ssd_scan(xf, dtf, Af, Bf, Cf, return_state=return_state)
    y = (out[0] if return_state else out).reshape(B, H, S, P).movedim(1, 2)
    return (y, out[1].reshape(B, H, P, N)) if return_state else y


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
