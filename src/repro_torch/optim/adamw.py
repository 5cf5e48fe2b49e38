"""AdamW and its schedule over a dict of tensors keyed by parameter name.

Port of ``repro/optim/adamw.py``.  Where the reference maps over a pytree,
these functions take flat dicts ``{name: tensor}`` (a model's
``named_parameters()``, its gradients, the moments), in the same math: f32
throughout, the step counter an int32 tensor, the moments f32, or bf16
under ``bf16_moments``.  The reference donates its buffers to the jitted
step; here :func:`adamw_update` writes the new parameters and moments in
place, under ``no_grad``, and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "clip_by_global_norm",
]

F32 = torch.float32
Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    bf16_moments: bool = False
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio·lr``."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(F32))) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: Tree, max_norm: float) -> Tuple[Tree, torch.Tensor]:
    gn = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: (x.to(F32) * scale).to(x.dtype) for k, x in tree.items()}, gn


def adamw_init(params: Tree, cfg: AdamWConfig):
    mdt = torch.bfloat16 if cfg.bf16_moments else F32
    device = next(iter(params.values())).device if params else None
    return {
        "m": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=mdt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, opt_state, cfg: AdamWConfig):
    """Returns (params, new_opt_state, metrics); the parameters and moments
    are updated in place, one leaf at a time (each leaf's clipped gradient
    and f32 temporaries are freed before the next)."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(F32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for k, p in params.items():
        gf, m, v = grads.pop(k).to(F32), opt_state["m"][k], opt_state["v"][k]
        mf = m.to(F32) * b1 + gf * (1 - b1)
        vf = v.to(F32) * b2 + gf * gf * (1 - b2)
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        p.copy_(p.to(F32) - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, new_state, metrics
