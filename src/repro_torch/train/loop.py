"""Training step + loop.

Port of ``repro/train/loop.py``.  ``make_train_step`` builds the step:
microbatch gradient accumulation in f32 (activation memory bound by one
microbatch), per-repeat remat (``forward(..., remat=True)``), a numerically
stable cross entropy in f32, AdamW, and metric aggregation.  Gradients come
from ``loss.backward()``: on the card the forward launches the flash and
SwiGLU kernels, whose wrappers carry their VJPs (``kernels/``); on the CPU
autograd runs through the kernels' plain versions.

``Trainer`` runs the long training loop: weights from ``init_params`` on a
seeded ``torch.Generator``, checkpoint/restore (atomic + async, in the
reference's format, so either package restores the other's checkpoints),
the health monitor's step hook, and deterministic data.  The reference's
``grad_shardings`` (ZeRO constraints on the accumulator) has no counterpart
on one card, as ``constrain`` has none.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import named_from_tree, reference_tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import spans

F32 = torch.float32

__all__ = ["TrainConfig", "make_train_step", "make_eval_step", "loss_fn", "Trainer"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1          # gradient-accumulation steps per train step
    remat: bool = True
    moe_impl: str = "einsum"
    optim: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_fn(
    params: T.Transformer, cfg: ArchConfig, tokens: Optional[torch.Tensor],
    labels: torch.Tensor, moe_impl: str = "einsum", remat: bool = False,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy in f32, numerically stable (the max
    carries no gradient), and accuracy.  ``labels`` cover the trailing
    positions: a VLM's image prefix is unlabelled, an audio encoder's every
    frame is labelled, text's every position."""
    inputs = {}
    if tokens is not None:
        inputs["tokens"] = tokens
    if embeds is not None:
        inputs["embeds"] = embeds
    logits = T.forward(params, cfg, inputs, mode="train", moe_impl=moe_impl, remat=remat)
    logits = logits[:, -labels.shape[1]:].to(F32)
    labels = labels.long()
    m = logits.amax(dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    loss = nll.mean()
    acc = (logits.argmax(-1) == labels).to(F32).mean()
    return loss, {"loss": loss.detach(), "accuracy": acc}


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the model (a ``Transformer``), updated in place; its
    parameters are set to require grad.  ``batch`` = {"labels": [B, L]}
    plus "tokens" and/or "embeds".  The batch splits into
    ``tcfg.microbatches`` accumulation steps run one after the other; their
    gradients are summed in f32, each divided by the count, then cast to
    the parameters' dtype.  A parameter the loss does not read gets a zero
    gradient, as under ``jax.grad``.

    Spans (``runtime.spans``, each with device time): ``train.step`` holds
    a ``train.microbatch`` per microbatch (``train.forward``,
    ``train.backward``, ``train.accumulate``) and ``train.update`` (the
    final cast, the global norm, the clip and AdamW); the accumulators'
    allocation is a ``train.accumulate`` of the step's own."""

    def grads_of(params: T.Transformer, batch):
        for p in params.parameters():
            p.grad = None
        with spans.span("train.forward", device=True):
            loss, metrics = loss_fn(params, cfg, batch.get("tokens"), batch["labels"],
                                    moe_impl=tcfg.moe_impl, remat=tcfg.remat,
                                    embeds=batch.get("embeds"))
        with spans.span("train.backward", device=True):
            loss.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return grads, metrics

    def step(params: T.Transformer, opt_state, batch):
        with spans.span("train.step", device=True):
            params.requires_grad_(True)
            named = dict(params.named_parameters())
            acc = tcfg.microbatches
            if acc == 1:
                with spans.span("train.microbatch", device=True):
                    grads, metrics = grads_of(params, batch)
            else:
                mb_batch = {k: v.reshape(acc, v.shape[0] // acc, *v.shape[1:])
                            for k, v in batch.items() if v is not None}
                with spans.span("train.accumulate", device=True):
                    grads = {n: torch.zeros(p.shape, dtype=F32, device=p.device)
                             for n, p in named.items()}
                    dev = params.embed.device
                    metrics = {k: torch.zeros((), dtype=F32, device=dev)
                               for k in ("loss", "accuracy")}
                for i in range(acc):
                    with spans.span("train.microbatch", device=True):
                        g, m = grads_of(params, {k: v[i] for k, v in mb_batch.items()})
                        with spans.span("train.accumulate", device=True):
                            for n, a in grads.items():
                                a += g.pop(n).to(F32) / acc
                            metrics = {k: a + m[k] / acc for k, a in metrics.items()}
            with spans.span("train.update", device=True):
                grads = {n: grads.pop(n).to(p.dtype) for n, p in named.items()}
                _, opt_state, om = adamw_update(named, grads, opt_state, tcfg.optim)
                metrics = dict(metrics, **om)
            return params, opt_state, metrics

    return step


def make_eval_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, cfg, batch["tokens"], batch["labels"],
                                 moe_impl=tcfg.moe_impl, embeds=batch.get("embeds"))
        return metrics

    return step


# --------------------------------------------------------------------------- #
# the training loop
# --------------------------------------------------------------------------- #
class Trainer:
    """Checkpointed training loop with failure/straggler hooks."""

    def __init__(
        self,
        cfg: ArchConfig,
        tcfg: TrainConfig,
        dataset,
        ckpt_manager=None,
        ckpt_every: int = 100,
        monitor=None,          # runtime.elastic.HealthMonitor (optional)
        seed: int = 0,
        device: DeviceLike = "cuda",
    ):
        self.cfg = cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.monitor = monitor
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, tcfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = T.init_params(cfg, gen, device=self.device)
        self.params.requires_grad_(True)
        self.opt_state = adamw_init(dict(self.params.named_parameters()), tcfg.optim)
        self.step = 0
        self.history = []

    def state_tree(self, device: DeviceLike = "cpu") -> Dict[str, Any]:
        """``{"params": ..., "opt": {"m", "v", "step"}}`` in the reference's
        tree (what its Trainer checkpoints), on ``device`` (``"meta"``: the
        shapes alone)."""
        def tree(named):
            return reference_tree(self.cfg, named, device)

        return {"params": tree(dict(self.params.named_parameters())),
                "opt": {"m": tree(self.opt_state["m"]), "v": tree(self.opt_state["v"]),
                        "step": self.opt_state["step"].to(device)}}

    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state, manifest = self.ckpt.restore(latest, like=self.state_tree("meta"))
        with torch.no_grad():
            for src, dst in ((state["params"], dict(self.params.named_parameters())),
                             (state["opt"]["m"], self.opt_state["m"]),
                             (state["opt"]["v"], self.opt_state["v"])):
                for name, t in named_from_tree(self.cfg, src).items():
                    dst[name].copy_(t)
        self.opt_state["step"] = state["opt"]["step"].to(self.device)
        self.step = int(manifest["step"])
        return True

    def run(self, n_steps: int, log_every: int = 10, log=print) -> Dict[str, Any]:
        t_start = time.monotonic()
        target = self.step + n_steps
        while self.step < target:
            batch = self.dataset.batch(self.step)
            feed = {"tokens": torch.as_tensor(batch.inputs, device=self.device),
                    "labels": torch.as_tensor(batch.labels, device=self.device)}
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, feed)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            self.step += 1
            self.history.append(metrics)
            if self.monitor is not None:
                self.monitor.record_step(self.step, dt)
            if log_every and self.step % log_every == 0:
                log(f"step {self.step:6d} loss={metrics['loss']:.4f} "
                    f"acc={metrics['accuracy']:.3f} ({dt*1e3:.0f} ms)")
            if self.ckpt is not None and self.step % self.ckpt_every == 0:
                self.ckpt.save(self.step, self.state_tree(), blocking=False)
        if self.ckpt is not None:
            self.ckpt.wait()
        return {
            "steps": self.step,
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "wall_s": time.monotonic() - t_start,
        }
