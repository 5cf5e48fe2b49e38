"""Closed-loop serving through ``repro_torch.serve.Engine``.

Parameters (the cell's ``traffic`` object): ``clients`` clients, each of which
submits its next request as soon as its last one has completed;
``ServeConfig(slots, max_seq)``; prompts of a length from a fixed set of
``length_points`` lengths spread evenly over [``prompt_min``, ``prompt_max``]
(each seed takes the same set, in its own order) and of tokens drawn
uniformly from the vocabulary; ``new_tokens`` tokens each, greedy.

Clients start one after another, ``new_tokens / clients`` ticks apart, and
the loop runs until every client has completed a request (set-up).  The
window then runs whole ticks for ``--seconds``.  A token is stamped when the
tick that produced it returns.  End to end: tokens emitted in the window
over its wall time; the 95th percentile of submit-to-first-token over the
requests completed in the window; the 95th percentile of the gaps between a
request's successive tokens, the later one in the window.

Correct: after the window, a sample drawn from the seed of the requests
completed in it (the longest prompt among them always) is run through the
plain reference (:mod:`port_bench.reference.lm`) over prompt and served
tokens.  At each served token the gap is how far its reference logit lies
below the reference's best; the mean gap over every served token is held to
the cell's ``mean_logit_gap`` limit (the widest gap, which does not separate
the program from the float8 control, is logged beside it).

The kernels' bound over the traced span counts only what was launched: each
traced tick's launches of each kernel family, read from the port's launch
counters, are held against the calls the tick's prefills and decode make
(:func:`port_bench.work.tick_work`).  A family launched as often as that
adds its bound; one not launched at all (off the path) adds nothing; any
other count leaves the bound unread, and the metrics that need it silent.
"""
from __future__ import annotations

import dataclasses
import importlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench import archcfg, weights, work
from port_bench.harness import Cell, Record, log, percentile, process_age_s
from port_bench.reference import lm
from port_bench.trace import Trace, top


@dataclasses.dataclass
class Req:
    client: int
    prompt: List[int]
    submit: float
    handle: object = None
    stamps: List[float] = dataclasses.field(default_factory=list)
    done_at: Optional[float] = None


def launches() -> Dict[str, int]:
    """Launches so far by kernel family, from the port's launch counters:
    ``ssd``, ``flash``, ``swiglu`` (dense) and ``experts``."""
    out = {"ssd": 0, "flash": 0, "swiglu": 0, "experts": 0}
    for mod, fam in (("ssd_scan", "ssd"), ("flash_attention", "flash"),
                     ("swiglu_matmul", "swiglu")):
        lib = importlib.import_module("repro_torch.kernels." + mod).LIBRARY
        for variant, n in lib.counts.items():
            out["experts" if variant.startswith("experts_") else fam] += n
    return out


class Traffic:
    """The seed's requests, in order: fixed lengths, a seed's order, random tokens."""

    def __init__(self, p: Dict, vocab: int, seed: int):
        k = p["length_points"]
        self.lengths = np.rint(np.linspace(p["prompt_min"], p["prompt_max"], k)).astype(int)
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(k)
        self.vocab, self.i = vocab, 0

    def next_prompt(self) -> List[int]:
        L = int(self.lengths[self.order[self.i % len(self.order)]])
        self.i += 1
        return self.rng.integers(0, self.vocab, size=L).tolist()


class Server:
    """The engine under its clients, and what the clients saw."""

    def __init__(self, cell: Cell, seed: int):
        from repro_torch.serve import Engine, ServeConfig

        self.cell, self.p = cell, cell.workload["traffic"]
        conf = cell.conf
        self.arch = conf["arch"]
        self.kinds = archcfg.layer_kinds(self.arch)
        self.dev = torch.device(cell.device)
        self.W = weights.draw(conf, seed, self.dev)
        cfg = archcfg.port_config(self.arch, conf["name"])
        model = weights.to_port(cfg, self.W, weights.DTYPES[conf["dtype"]])
        self.engine = Engine(cfg, model, ServeConfig(max_seq=self.p["max_seq"],
                                                     slots=self.p["slots"]), device=self.dev)
        self.traffic = Traffic(self.p, self.arch["vocab"], seed)
        self.reqs: List[Req] = []
        self.open: List[Req] = []
        self.ticks: List[tuple] = []   # (start, end, prefill lengths, live rows)
        self.counting = False          # count launches a tick (the traced span)
        self.launched: Dict[int, Dict[str, int]] = {}

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def submit(self, client: int, now: float) -> None:
        r = Req(client, self.traffic.next_prompt(), now)
        r.handle = self.engine.submit(r.prompt, max_new=self.p["new_tokens"])
        self.reqs.append(r)
        self.open.append(r)

    def tick(self) -> List[Req]:
        """One engine tick; stamps its tokens; returns the requests it completed."""
        queued = [r for r in self.open if not r.handle.out]
        before = launches() if self.counting else None
        t0 = time.perf_counter()
        live = self.engine.tick()
        t1 = time.perf_counter()
        if before is not None:
            self.launched[len(self.ticks)] = {k: n - before[k] for k, n in launches().items()}
        admitted = [len(r.prompt) for r in queued if r.handle.out]
        self.ticks.append((t0, t1, admitted, live))
        done = []
        for r in self.open:
            r.stamps.extend([t1] * (len(r.handle.out) - len(r.stamps)))
            if r.handle.done:
                r.done_at = t1
                done.append(r)
        self.open = [r for r in self.open if r.done_at is None]
        return done

    def warm_up(self) -> None:
        """The shortest and the longest prompt of the mix, decoded to the end
        (requests of their own, outside the cell's sequence)."""
        rng = np.random.default_rng(0)
        for L in (self.p["prompt_min"], self.p["prompt_max"]):
            self.engine.submit(rng.integers(0, self.arch["vocab"], size=L).tolist(),
                               max_new=self.p["new_tokens"])
        self.engine.run_until_done()
        self.sync()

    def ramp(self) -> None:
        """Start the clients one after another and run until each has
        completed a request."""
        clients, stride = self.p["clients"], self.p["new_tokens"] / self.p["clients"]
        started, served, n = 0, set(), 0
        while len(served) < clients:
            while started < clients and started * stride <= n:
                self.submit(started, time.perf_counter())
                started += 1
            for r in self.tick():
                served.add(r.client)
                self.submit(r.client, r.done_at)
            n += 1

    def window(self, seconds: float, trace: Optional[Dict] = None):
        """Whole ticks for ``seconds``; with ``trace`` ({"start", "ticks"}),
        the profiler around ``ticks`` ticks from ``start`` seconds in.
        Returns (t0, t_end, index of the first tick, [first traced tick,
        end, trace] or None)."""
        first = len(self.ticks)
        tracer, traced = None, None
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if trace and tracer is None and traced is None and now >= trace["start"]:
                tracer, traced = Trace(), [len(self.ticks), None, None]
                self.counting = True
                tracer.start()
            for r in self.tick():
                self.submit(r.client, r.done_at)
            now = time.perf_counter() - t0
            if tracer is not None and len(self.ticks) - traced[0] >= trace["ticks"]:
                traced[1] = len(self.ticks)
                traced[2] = tracer.stop()
                tracer, self.counting = None, False
            if now >= seconds and (not trace or (traced and traced[2] is not None)):
                break
        return t0, self.ticks[-1][1], first, traced


def end_to_end(srv: Server, t0: float, t1: float) -> Dict[str, float]:
    tokens = sum(1 for r in srv.reqs for s in r.stamps if t0 < s <= t1)
    done = [r for r in srv.reqs if r.done_at is not None and t0 < r.done_at <= t1]
    ttft = [r.stamps[0] - r.submit for r in done]
    gaps = [b - a for r in srv.reqs for a, b in zip(r.stamps, r.stamps[1:]) if t0 < b <= t1]
    return {"output_tokens_per_s": tokens / (t1 - t0),
            "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else None,
            "token_gap_p95_ms": percentile(gaps, 95) * 1e3 if gaps else None}


def readings(srv: Server, first: int, traced) -> Dict:
    """Host-clock readings over the window's ticks outside the traced span,
    and the bound of the kernels launched in the traced ticks."""
    skip = range(traced[0], traced[1]) if traced else range(0)
    ticks = [t for i, t in enumerate(srv.ticks[first:], first) if i not in skip]
    out = {"tick_ms": [(b - a) * 1e3 for a, b, _, _ in ticks]}
    tokens = sum(sum(adm) + live for _, _, adm, live in ticks)
    wall = sum(b - a for a, b, _, _ in ticks)
    out["model_flops_per_s"] = 2.0 * archcfg.active_params(srv.arch) * tokens / wall
    if traced:
        out["kernel_bound_s"], out["launches"] = launched_bound_s(srv, range(*traced[:2]))
    return out


def launched_bound_s(srv: Server, ticks) -> tuple:
    """(Σ bound in seconds of the kernel families launched in ``ticks``, or
    None where a family's launches differ from the tick's calls and are not
    0; {family: [launched, calls]} over those ticks)."""
    bound, sound, seen = 0.0, True, {}
    for i in ticks:
        _, _, adm, live = srv.ticks[i]
        want = work.tick_work(srv.arch, srv.kinds, adm, live)
        got = srv.launched.get(i, {})
        for fam in set(want) | set(got):
            calls, ms = want.get(fam, (0, 0.0))
            n = got.get(fam, 0)
            tally = seen.setdefault(fam, [0, 0])
            tally[0] += n
            tally[1] += calls
            if n == calls:
                bound += ms
            elif n:
                sound = False
    return (1e-3 * bound if sound else None), seen


@torch.no_grad()
def served_logits(srv: Server, reqs: List[Req], quant=None) -> List[torch.Tensor]:
    """The reference's logits [new_tokens, V] at each served position of
    each request: prompt plus served tokens, the prompt routed as one
    prefill and each served token alone."""
    out = []
    with lm.exact_f32():
        for r in reqs:
            served = r.handle.out
            toks = torch.tensor([r.prompt + served[:-1]], device=srv.dev)
            L = len(r.prompt)
            groups = lm.serve_groups(srv.arch, L, len(served) - 1)
            pos = torch.arange(L - 1, L - 1 + len(served), device=srv.dev)
            out.append(lm.forward(srv.W, srv.arch, toks, groups, pos, quant)[0])
    return out


def sample(srv: Server, t0: float, t1: float, n: int, seed: int) -> List[Req]:
    done = [r for r in srv.reqs if r.done_at is not None and t0 < r.done_at <= t1]
    if not done:
        raise RuntimeError("no request completed in the window: nothing to judge")
    longest = max(done, key=lambda r: len(r.prompt))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def free_program(srv: Server) -> None:
    """Drop the engine (its cache and the model's handles), keep the weights."""
    srv.engine = None
    if srv.dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def serve(cell: Cell, seed: int, seconds: float, trace=None):
    """Set-up, then the window; returns (server, its readings)."""
    if cell.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    srv = Server(cell, seed)
    phases = {"weights and engine": process_age_s()}
    if trace:  # the profiler's own first start, outside the window
        Trace().start_stop()
    srv.warm_up()
    phases["warm-up"] = process_age_s()
    srv.ramp()
    srv.sync()
    setup_s = phases["ramp"] = process_age_s()
    log("set-up, seconds from process start at the end of each phase: "
        + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()))
    t0, t1, first, traced = srv.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    e2e = end_to_end(srv, t0, t1)
    e2e["setup_s"] = setup_s
    done = [r for r in srv.reqs if r.done_at is not None and t0 < r.done_at <= t1]
    in_flight = [r for r in srv.reqs if r.done_at is None and r.submit <= t1]
    read = readings(srv, first, traced)
    free_program(srv)
    check = sample(srv, t0, t1, cell.workload["traffic"]["check_requests"], seed)
    return srv, dict(e2e=e2e, read=read, traced=traced, peak=peak, check=check,
                     attempted=len(done) + len(in_flight))


def run(cell: Cell) -> Record:
    p = cell.workload["traffic"]
    srv, out = serve(cell, cell.seed, cell.seconds, p["trace"] if cell.trace else None)
    check = out["check"]
    t = time.perf_counter()
    gaps = gap_stats(served_logits(srv, check), [r.handle.out for r in check], "logit_gap")
    log(f"reference {time.perf_counter() - t:.1f} s over {len(check)} requests; {gaps}")
    read, trace = out["read"], None
    if "launches" in read:
        log(f"kernel launches in the traced span, by family [launched, calls]: {read['launches']}")
    if out["traced"]:
        tr = out["traced"][2]
        read["trace"] = tr
        trace = {"busy_s": tr["busy_s"], "window_s": tr["window_s"],
                 "breakdown": {"device_ops": top(tr["by_name"]),
                               "idle_gaps": top(tr["idle_by_host"])}}
    e2e = {k: v for k, v in out["e2e"].items() if v is not None}
    return Record(e2e, read, checks_of(cell, check, gaps), attempted=out["attempted"],
                  failed=0, memory_peak_bytes=out["peak"], trace=trace)


def checks_of(cell: Cell, check: List[Req], gaps: Dict[str, float]) -> Dict[str, Dict]:
    """The numbers compared, each with its limit: the served tokens judged
    (at least ``check_min_tokens``) and their mean logit gap."""
    return {"served_tokens": {"value": sum(len(r.handle.out) for r in check),
                              "limit": cell.workload["traffic"]["check_min_tokens"],
                              "least": True},
            "mean_logit_gap": {"value": gaps["logit_gap.mean"],
                               "limit": cell.workload["limits"]["mean_logit_gap"]}}


def gap_stats(ref: List[torch.Tensor], tokens: List[List[int]], tag: str) -> Dict[str, float]:
    """How far each token's reference logit lies below the reference's best
    at its position: the widest gap (over all tokens, prefill's and decode's
    apart), the mean gap and the share of tokens above 0.1."""
    g = [z.max(-1).values - z.gather(-1, torch.tensor(t, device=z.device)[:, None])[:, 0]
         for z, t in zip(ref, tokens)]
    first = torch.stack([x[0] for x in g])
    rest = torch.cat([x[1:] for x in g])
    every = torch.cat(g)
    return {tag: float(every.max()), tag + ".prefill": float(first.max()),
            tag + ".decode": float(rest.max()), tag + ".mean": float(every.mean()),
            tag + ".over_0.1": float((every > 0.1).float().mean())}


def limit_readings(cell: Cell, role: str, seed: int) -> Dict[str, float]:
    """The numbers a limit is set from, for one seed: the program's gaps
    and whether its run is correct (``role`` "program"), or also the
    control's: the reference in float8 in the program's place, each
    position's first token under it judged by the float32 reference, put
    through the same checks ("control")."""
    srv, out = serve(cell, seed, cell.seconds)
    check = out["check"]
    t = time.perf_counter()
    ref = served_logits(srv, check)
    got = {"reference_s": time.perf_counter() - t, **out["e2e"]}
    gaps = gap_stats(ref, [r.handle.out for r in check], "logit_gap")
    got.update(gaps)
    got["served_tokens"] = sum(len(r.handle.out) for r in check)
    got["correct"] = Record({}, {}, checks_of(cell, check, gaps), 0, 0).correct
    if role == "control":
        low = served_logits(srv, check, quant="fp8")
        ctl = gap_stats(ref, [z.argmax(-1).tolist() for z in low], "logit_gap")
        got.update({"control_" + k: v for k, v in ctl.items()})
        got["control_correct"] = Record({}, {}, checks_of(cell, check, ctl), 0, 0).correct
    return got
