"""Index-based MoE dispatch (scatter/gather): the reference's perf variant.

Port of ``repro/models/moe_scatter.py``.  The same routing and capacity
semantics as ``layers._moe_chunk_einsum`` (arrival order is token-major
within the group), with the one-hot dispatch and combine products replaced
by an index scatter into the experts' capacity buffer and a gather back.
The experts run through the same expert-batched SwiGLU kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoESpec
from repro_torch.models.layers import (
    expert_arrivals, expert_products, moe_capacity, moe_route, moe_tally,
)
from repro_torch.runtime import spans

__all__ = ["moe_chunk_scatter"]


def moe_chunk_scatter(p, m: MoESpec, xc: torch.Tensor, tally=None) -> torch.Tensor:
    """Per-group scatter dispatch: xc [G, s, D] -> [G, s, D].

    The buffer is laid out [E, G, C] (plus one row that takes every dropped
    token), so the experts read it as [E, G·C, D] with no copy.  ``tally``:
    see ``layers.moe_tally``."""
    G, s, D = xc.shape
    E, K, C = m.n_experts, m.top_k, moe_capacity(m, s)
    with spans.span("model.moe.route"):
        gate_k, idx_k = moe_route(p, m, xc)
    with spans.span("model.moe.dispatch"):
        seen = expert_arrivals(F.one_hot(idx_k, E).sum(2))        # [G, s, E]
        pos = torch.gather(seen, 2, idx_k) - 1                    # [G, s, K]
        in_cap = pos < C
        group = torch.arange(G, device=xc.device)[:, None, None]
        flat_idx = torch.where(in_cap, (idx_k * G + group) * C + pos, E * G * C)  # [G, s, K]

        buf = xc.new_zeros((E * G * C + 1, D))
        src = xc[:, :, None, :].expand(G, s, K, D).reshape(-1, D)
        buf[flat_idx.reshape(-1)] = src  # only the drop row takes more than one token
        if tally is not None:
            moe_tally(tally, m, C, in_cap.sum(-1))
    with spans.span("model.moe.experts"):
        ye = expert_products(p, buf[:E * G * C].view(E, G * C, D))

    with spans.span("model.moe.combine"):
        flat = torch.cat([ye.reshape(E * G * C, D), ye.new_zeros((1, D))], dim=0)
        out_k = flat[flat_idx.reshape(-1)].reshape(G, s, K, D)
        wk = (gate_k * in_cap).to(xc.dtype)
        return torch.einsum("gsk,gskd->gsd", wk, out_k)
