"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``: the same functions with f32 accumulation.
The kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30  # finite: a fully masked row stays finite, as in the reference


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Sk, D]
    v: torch.Tensor,  # [BH, Sk, D]
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.to(F32), k.to(F32)) * sc
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        mask = kpos[None, :] <= (qpos[:, None] + (Sk - Sq))
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)


def swiglu_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """silu(x @ wg) * (x @ wu), f32 accumulation."""
    g = torch.einsum("md,df->mf", x.to(F32), wg.to(F32))
    u = torch.einsum("md,df->mf", x.to(F32), wu.to(F32))
    return (F.silu(g) * u).to(x.dtype)
