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


def ssd_scan_ref(
    x: torch.Tensor,   # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]      (f32, post-softplus)
    A: torch.Tensor,   # [BH]         (f32, negative)
    B: torch.Tensor,   # [BH, S, N]
    C: torch.Tensor,   # [BH, S, N]
    return_state: bool = False,
):
    """Exact sequential SSD recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    y_t = C_t · h_t.  Returns y [BH, S, P] in x's dtype and, with
    ``return_state``, also the final state h [BH, P, N] in f32."""
    BH, S, P = x.shape
    N = B.shape[-1]
    xf, Bf, Cf = x.to(F32), B.to(F32), C.to(F32)
    dtf, Af = dt.to(F32), A.to(F32)
    h = torch.zeros((BH, P, N), dtype=F32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)
        h = h * dA[:, None, None] + torch.einsum(
            "bp,bn,b->bpn", xf[:, t], Bf[:, t], dtf[:, t])
        ys.append(torch.einsum("bn,bpn->bp", Cf[:, t], h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def swiglu_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """silu(x @ wg) * (x @ wu), f32 accumulation."""
    g = torch.einsum("md,df->mf", x.to(F32), wg.to(F32))
    u = torch.einsum("md,df->mf", x.to(F32), wu.to(F32))
    return (F.silu(g) * u).to(x.dtype)
