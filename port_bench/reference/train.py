"""Plain PyTorch reference of a training step: loss, gradients and AdamW.

Follows the configuration's ``train`` object from the weights the benchmark
drew: each step's loss is the mean next-token cross entropy over the step's
rows (microbatches of equal size, so the mean of their means), computed in
float32 with TF32 off, a few rows at a time with each layer recomputed in
the backward; the gradient is clipped to the global norm ``grad_clip``;
AdamW (bias-corrected moments, decoupled weight decay, linear warmup then a
cosine to ``min_lr_ratio``) updates every leaf in float32, and the new value
is stored in the leaf's own dtype (the one it was drawn in), as the model
keeps it.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference import lm

F32 = torch.float32


def lr_at(o: Dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1),
                   0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_ratio"] + (1 - o["min_lr_ratio"]) * cos)


def grads(W: Dict[str, torch.Tensor], arch: Dict, tokens: torch.Tensor, labels: torch.Tensor,
          block_rows: int, quant=None):
    """(loss, float32 gradients) of the mean cross entropy over all rows."""
    for p in W.values():
        p.grad = None
    rows, n = tokens.shape[0], labels.numel()
    total = 0.0
    for a in range(0, rows, block_rows):
        z = lm.forward(W, arch, tokens[a:a + block_rows], quant=quant, checkpoint_layers=True)
        loss = F.cross_entropy(z.reshape(-1, z.shape[-1]), labels[a:a + block_rows].reshape(-1),
                               reduction="sum") / n
        loss.backward()
        total += float(loss.detach())
        del z, loss
    return total, {k: p.grad for k, p in W.items()}


def follow(W0: Dict[str, torch.Tensor], arch: Dict, train: Dict, batches: List[Dict],
           block_rows: int, quant=None) -> Dict:
    """Run len(batches) steps from W0 (``quant``: see :func:`lm.forward`).
    Returns each step's loss, the first step's clipped gradient (its norm by
    leaf) and each leaf's change after the last step (its norm by leaf)."""
    o = train["optimizer"]
    W = {k: v.detach().to(F32, copy=True).requires_grad_(True) for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    out = {"loss": []}
    with lm.exact_f32():
        for t, batch in enumerate(batches, start=1):
            loss, g = grads(W, arch, batch["tokens"], batch["labels"], block_rows, quant)
            out["loss"].append(loss)
            gn = math.sqrt(sum(float(x.double().pow(2).sum()) for x in g.values()))
            scale = min(o["grad_clip"] / max(gn, 1e-9), 1.0)
            if t == 1:
                out["grad_norm"] = {k: float(x.norm()) * scale for k, x in g.items()}
            lr = lr_at(o, t)
            bc1, bc2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
            with torch.no_grad():
                for k, p in W.items():
                    gk = g[k] * scale
                    m[k].mul_(o["b1"]).add_(gk, alpha=1 - o["b1"])
                    v2[k].mul_(o["b2"]).addcmul_(gk, gk, value=1 - o["b2"])
                    step = (m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + o["eps"])
                    p.copy_((p - lr * (step + o["weight_decay"] * p)).to(W0[k].dtype).to(F32))
                    p.grad = None
            del g
    out["delta_norm"] = {k: float((W[k].detach() - W0[k].to(F32)).norm()) for k in W}
    return out
