"""Batched inference engine: prefill + KV-cache decode with slot scheduling.

Port of ``repro/serve/engine.py``.  :class:`Engine` does continuous batching
over a fixed pool of cache *slots*: a queued request claims a free slot, is
prefilled alone (batch 1) into a fresh single-sequence cache that is then
spliced into its slot, and every engine tick decodes one token for all
slots at once (idle slots too), with a per-slot position vector so that
ragged slots stay exact.  Decoding is greedy (``argmax``).

The steps run eagerly on the engine's device (CUDA unless the caller passes
``device="cpu"``); prefill attention (GQA or MLA), every SwiGLU MLP, the
routed experts' products and the SSD scan of every mamba2 prefill go through
the port's CUDA kernels there.  The cache (k/v, MLA's latent and rope key,
an SSM's conv window and state, or Jamba's mix of both in its ``super``
segment) is updated in place.  The engine takes token prompts, as the
reference's does; a VLM's image embeddings go through the pure steps
(``make_prefill_step`` with ``{"embeds", "tokens"}``, then
``make_decode_step``), which the dry run's prefill and decode cells lower.  The
reference's steps return an SSM's conv window in the activations' dtype and
its engine keeps what they return, so here the window takes that dtype before
a step writes it (see :func:`_conv_in`).

Graceful degradation is wired as in the reference and duck-typed: with a
``monitor`` (``check(certificate=, slack=)``, ``record_step``) the engine
feeds it tick timings, asks for a verdict every ``check_every`` ticks and,
while unhealthy, admits at most one request per tick; with a ``planner``
(``replan(monitor, certificate=, slack=)``) an unhealthy verdict publishes
the replanned plan on ``engine.elastic_plan``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime import spans

__all__ = ["ServeConfig", "Request", "Engine", "make_prefill_step", "make_decode_step"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 32768
    slots: int = 8              # concurrent sequences (decode batch)
    moe_impl: str = "einsum"    # MoE dispatch of both steps: "einsum" or "scatter"


def make_prefill_step(cfg: ArchConfig, scfg: ServeConfig) -> Callable:
    """(params, cache, inputs) -> (last_logits [B,V], cache); ``inputs``:
    ``{"tokens"}``, ``{"embeds"}`` or both (``T.forward``)."""

    def step(params, cache, inputs):
        logits, cache = T.forward(params, cfg, inputs, mode="prefill", cache=cache,
                                  moe_impl=scfg.moe_impl)
        return logits[:, -1], cache

    return step


def make_decode_step(cfg: ArchConfig, scfg: ServeConfig) -> Callable:
    """(params, cache, tokens [B,1]) -> (logits [B,V], cache)."""

    def step(params, cache, tokens):
        logits, cache = T.decode_step(params, cfg, cache, tokens, moe_impl=scfg.moe_impl)
        return logits[:, 0], cache

    return step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    submitted_ns: int = dataclasses.field(default_factory=time.perf_counter_ns)


class Engine:
    """Continuous-batching engine over a fixed slot pool (one device)."""

    def __init__(
        self,
        cfg: ArchConfig,
        params: T.Transformer,
        scfg: ServeConfig = ServeConfig(),
        monitor=None,
        planner=None,
        certificate=None,
        check_every: int = 8,
        deadline_slack: float = 1.0,
        timing_source: Optional[Callable[[], List[Tuple[int, float]]]] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        on = next(params.parameters()).device
        if on.type != self.device.type or self.device.index not in (None, on.index):
            raise ValueError(f"params are on {on}, the engine on {self.device}")
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        # graceful-degradation wiring (all optional)
        self.monitor = monitor
        self.planner = planner
        self.certificate = certificate
        self.check_every = check_every
        self.deadline_slack = deadline_slack
        self.timing_source = timing_source
        self.degraded = False
        self.elastic_plan = None
        self._acked_dead: set = set()
        self.last_verdict: Optional[Dict[str, List[int]]] = None
        self._ticks = 0
        self._prefill1 = make_prefill_step(cfg, scfg)
        self._decode = make_decode_step(cfg, scfg)
        self._act_dtype = params.embed.dtype
        # slot-pool state: one shared batched cache, per-slot bookkeeping
        self.cache = T.init_cache(cfg, scfg.slots, scfg.max_seq, device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * scfg.slots
        self.slot_pos = [0] * scfg.slots
        self.next_tok = torch.zeros((scfg.slots, 1), dtype=torch.int64, device=self.device)
        self.queue: List[Request] = []
        self._rid = 0

    # ------------------------------------------------------------------ #
    def submit(self, prompt: List[int], max_new: int = 16) -> Request:
        r = Request(rid=self._rid, prompt=list(prompt), max_new=max_new)
        self._rid += 1
        self.queue.append(r)
        return r

    def _admit(self):
        """Claim free slots for queued requests; prefill their prompt.

        A request whose budget is exhausted by the prefill token
        (``max_new=1``) is finished here: it never occupies a slot and never
        pays a decode tick.  In degraded mode at most one request is admitted
        per tick: prefill is the expensive, bursty part of a tick."""
        admitted = 0
        for s in range(self.scfg.slots):
            if self.slot_req[s] is not None:
                continue
            while self.queue:
                if self.degraded and admitted >= 1:
                    return
                admitted += 1
                r = self.queue.pop(0)
                spans.mark("engine.queue", r.submitted_ns, rid=r.rid)
                with spans.span("engine.prefill", rid=r.rid, n=len(r.prompt)):
                    # per-slot prefill with a single-sequence cache
                    tmp_cache = _conv_in(
                        T.init_cache(self.cfg, 1, self.scfg.max_seq, device=self.device),
                        self._act_dtype)
                    toks = torch.tensor(r.prompt, dtype=torch.int64, device=self.device)[None, :]
                    last, tmp_cache = self._prefill1(self.params, tmp_cache, {"tokens": toks})
                with spans.span("engine.first_token", rid=r.rid):
                    tok0 = int(torch.argmax(last[0]))
                r.out.append(tok0)
                if len(r.out) >= r.max_new:
                    r.done = True  # finished at prefill; slot s stays free
                    continue
                with spans.span("engine.splice", rid=r.rid):
                    self.cache = _splice_cache(self.cache, tmp_cache, s)
                    self.next_tok[s, 0] = tok0
                self.slot_req[s] = r
                self.slot_pos[s] = len(r.prompt)
                break

    def check_health(self) -> Optional[Dict[str, List[int]]]:
        """Ask the monitor for a verdict; enter degraded mode if unhealthy.

        With a planner, an unhealthy verdict also produces a replanned plan
        on ``self.elastic_plan``; deaths a published replan already acted on
        are acknowledged and stop counting as unhealthy, so a later clean
        verdict leaves degraded mode.  Without a planner a dead worker keeps
        the engine degraded.  Returns the verdict (``None`` without a
        monitor)."""
        if self.monitor is None:
            return None
        self.last_verdict = verdict = self.monitor.check(
            certificate=self.certificate, slack=self.deadline_slack,
        )
        new_dead = [w for w in verdict["dead"] if w not in self._acked_dead]
        unhealthy = bool(
            new_dead or verdict["stragglers"] or verdict.get("deadline")
        )
        if unhealthy and self.planner is not None:
            plan = self.planner.replan(
                self.monitor, certificate=self.certificate,
                slack=self.deadline_slack,
            )
            if plan.action != "continue":
                self.elastic_plan = plan
                self._acked_dead.update(verdict["dead"])
        self.degraded = unhealthy
        return verdict

    def tick(self) -> int:
        """One engine iteration: admit + decode one token for all live slots."""
        with spans.span("engine.tick"):
            t0 = time.perf_counter()
            self._ticks += 1
            if self.monitor is not None and self._ticks % self.check_every == 0:
                self.check_health()
            with spans.span("engine.admit"):
                self._admit()
            live = [s for s in range(self.scfg.slots) if self.slot_req[s] is not None]
            if not live:
                self._record_tick(t0)
                return 0
            with spans.span("engine.decode"):
                self._decode_live(live)
            self._record_tick(t0)
            return len(live)

    def _decode_live(self, live: List[int]) -> None:
        """Decode one token for every slot and hand it to the live ones.

        A single fixed-shape decode step serves every slot (idle slots
        too); per-slot positions make ragged continuous batching exact."""
        with spans.span("engine.decode_step"):
            self.cache["pos"] = torch.tensor(self.slot_pos, dtype=torch.int64,
                                             device=self.device)
            self.cache = _conv_in(self.cache, self._act_dtype)
            logits, self.cache = self._decode(self.params, self.cache, self.next_tok)
            toks = torch.argmax(logits, dim=-1)
        with spans.span("engine.readback"):
            host = toks.tolist()
        for s in live:
            r = self.slot_req[s]
            r.out.append(host[s])
            self.slot_pos[s] += 1
            if len(r.out) >= r.max_new:
                r.done = True
                self.slot_req[s] = None
        self.next_tok = toks[:, None]

    def _record_tick(self, t0: float) -> None:
        """Feed the monitor this tick's timings: every worker's own time from
        ``timing_source`` (``() -> [(worker_id, dt), ...]``) where there is
        one, else the whole tick's wall time on worker 0."""
        if self.monitor is None:
            return
        times = self.timing_source() if self.timing_source is not None else None
        if times:
            for w, dt in times:
                self.monitor.record_step(self._ticks, dt, worker=w)
        else:
            self.monitor.record_step(self._ticks, time.perf_counter() - t0)

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                return
            self.tick()
        raise RuntimeError("engine did not drain")


def _conv_in(cache, dtype: torch.dtype):
    """Give an SSM cache's conv windows ``dtype`` (no-op for other caches).

    The reference's prefill and decode return the window in the activations'
    dtype and its engine keeps what they return: its pool starts in bf16,
    rounds the prefills spliced in before the first decode tick, and holds
    the activations' dtype from that tick on."""
    for positions in cache["segments"].values():
        for leaves in positions.values():
            if "conv" in leaves:
                leaves["conv"] = leaves["conv"].to(dtype)
    return cache


def _splice_cache(cache, single, slot: int):
    """Write a batch-1 cache into slot ``slot`` of the pooled cache, in place.

    Cache leaves are layer-stacked: ``[L, B, ...]`` — the slot is dim 1.
    """
    for seg, positions in cache["segments"].items():
        for pj, leaves in positions.items():
            for name, dst in leaves.items():
                dst[:, slot] = single["segments"][seg][pj][name][:, 0].to(dst.dtype)
    return cache
