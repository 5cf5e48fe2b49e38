"""Pretraining steps through ``repro_torch.train.loop.make_train_step``.

The job is the configuration's ``train`` object: rows of ``seq_len`` tokens,
``global_batch`` rows a step in ``microbatches`` accumulation steps, remat
a layer, AdamW.  The mix (the cell's ``traffic`` object) draws each step's
rows on the device from the seed and the step: row r takes tokens uniformly
from its own band of the vocabulary (band b of ``bands``, a seed's and a
step's permutation), band b holding V / bands tokens halved b mod
``narrowing`` times, so rows differ in their spread as documents do (prose,
code, tables, repeated boilerplate) and a row left out moves the loss.

Set-up builds the model and the optimizer state and runs the first
``check_steps`` steps through the same call and feed as the window, keeping
each step's loss, the first step's gradient as AdamW received it (from its
first moment after one step, m / (1 - b1)) and the parameters' change
after the last of them, by leaf.  The window runs whole steps for
``--seconds``: tokens of every step over the time they took.

Correct: the plain reference (:mod:`port_bench.reference.train`) follows the
same steps from the weights as drawn; three numbers, each the worst of its
kind: a step's loss gap (relative), a leaf's gradient-norm gap and a leaf's
change-norm gap, each over the larger of that leaf's reference norm and the
median leaf's.  Leaves whose reference gradient is under a thousandth of
the median leaf's are not counted in the change.  Those the cell's
``limits`` name are compared; the others are logged.
"""
from __future__ import annotations

import importlib
import math
import time
from typing import Dict, List

import torch

from port_bench import archcfg, weights, work
from port_bench.harness import Cell, Record, log, process_age_s
from port_bench.reference import train as ref_train
from port_bench.trace import Trace, top


class Data:
    def __init__(self, p: Dict, arch: Dict, tr: Dict, seed: int, device):
        self.rows, self.S = tr["global_batch"], tr["seq_len"]
        self.bands, self.base = p["bands"], arch["vocab"] // p["bands"]
        self.width = torch.tensor([max(1, self.base >> (b % p["narrowing"]))
                                   for b in range(self.bands)], device=device)
        self.seed, self.device = seed, device

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + step) % (1 << 63))
        band = torch.randperm(self.bands, generator=g, device=self.device)
        band = band.repeat(-(-self.rows // self.bands))[:self.rows]
        u = torch.rand((self.rows, self.S + 1), generator=g, device=self.device)
        toks = band[:, None] * self.base + (u * self.width[band][:, None]).long()
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def ssd_launches() -> Dict[str, int]:
    return dict(importlib.import_module("repro_torch.kernels.ssd_scan").LIBRARY.counts)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves: List[str]) -> Dict:
    """Each leaf's |got - want| over max(want, the median leaf's want)."""
    med = sorted(want[k] for k in want)[len(want) // 2]
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in leaves}


def gap_by_leaf(got: Dict[str, float], want: Dict[str, float], leaves: List[str]) -> float:
    """The worst leaf's gap (:func:`leaf_gaps`)."""
    return max(leaf_gaps(got, want, leaves).values())


def first_steps(cell: Cell, seed: int) -> Dict:
    """The model and optimizer state built from ``seed`` and driven through
    the first ``check_steps`` steps, with what they read."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.loop import TrainConfig, make_train_step

    conf, p = cell.conf, cell.workload["traffic"]
    arch, tr = conf["arch"], conf["train"]
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    W = weights.draw(conf, seed, dev)
    W0 = {k: v.clone() for k, v in W.items()}  # as drawn, for the reference
    cfg = archcfg.port_config(arch, conf["name"])
    model = weights.to_port(cfg, W, weights.DTYPES[conf["dtype"]])
    del W
    tcfg = TrainConfig(microbatches=tr["microbatches"], remat=tr["remat"],
                       optim=AdamWConfig(**tr["optimizer"]))
    st = dict(model=model, step_fn=make_train_step(cfg, tcfg), W0=W0,
              opt=adamw_init(dict(model.named_parameters()), tcfg.optim),
              data=Data(p, arch, tr, seed, dev), loss=[])
    for t in range(1, p["check_steps"] + 1):
        st["model"], st["opt"], met = st["step_fn"](st["model"], st["opt"], st["data"].batch(t))
        st["loss"].append(float(met["loss"]))
        if t == 1:
            b1 = tr["optimizer"]["b1"]
            st["grad_norm"] = {k: float(m.norm()) / (1 - b1) for k, m in st["opt"]["m"].items()}
    st["delta_norm"] = {k: float((q.detach().float() - W0[k].float()).norm())
                        for k, q in st["model"].named_parameters()}
    return st


def free_program(st: Dict) -> None:
    for k in ("model", "opt", "step_fn"):
        st.pop(k, None)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reference(cell: Cell, st: Dict, quant=None) -> Dict:
    K = cell.workload["traffic"]["check_steps"]
    return ref_train.follow(st["W0"], cell.conf["arch"], cell.conf["train"],
                            [st["data"].batch(t) for t in range(1, K + 1)],
                            cell.workload["traffic"]["ref_block_rows"], quant)


def gaps(got: Dict, ref: Dict) -> Dict[str, float]:
    """loss_gap, grad_gap, delta_gap of ``got`` against ``ref`` (the change
    over the leaves the reference's gradient moves)."""
    med = sorted(ref["grad_norm"].values())[len(ref["grad_norm"]) // 2]
    moved = [k for k, g in ref["grad_norm"].items() if g >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": gap_by_leaf(got["grad_norm"], ref["grad_norm"], list(ref["grad_norm"])),
            "delta_gap": gap_by_leaf(got["delta_norm"], ref["delta_norm"], moved)}


def run(cell: Cell) -> Record:
    tr = cell.conf["train"]
    if cell.trace:  # the profiler's own first start, outside the window
        Trace().start_stop()
    st = first_steps(cell, cell.seed)
    cuda = cell.device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = process_age_s()

    tokens = tr["global_batch"] * tr["seq_len"]
    steps, trace, bound_s, step = [], None, 0.0, cell.workload["traffic"]["check_steps"]
    t0 = time.perf_counter()
    while True:
        step += 1
        traced = cell.trace and trace is None and len(steps) >= 1
        if traced:
            before, tracer = ssd_launches(), Trace()
            tracer.start()
        ts = time.perf_counter()
        st["model"], st["opt"], met = st["step_fn"](st["model"], st["opt"], st["data"].batch(step))
        loss = float(met["loss"])
        te = time.perf_counter()
        if traced:
            trace = tracer.stop()
            calls = {v: n - before.get(v, 0) for v, n in ssd_launches().items()}
            rows = tr["global_batch"] // tr["microbatches"]
            bound_s = 1e-3 * sum(
                n * work.ssd_call_ms(cell.conf["arch"], rows, tr["seq_len"],
                                     backward=v.endswith("bwd"))
                for v, n in calls.items())
        steps.append((ts, te, traced, loss))
        if te - t0 >= cell.seconds and (trace or not cell.trace):
            break
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    plain = [(a, b) for a, b, traced, _ in steps if not traced]
    active = archcfg.active_params(cell.conf["arch"])
    read = {"traced_steps": 1 if trace else 0, "kernel_bound_s": bound_s,
            "model_flops_per_s": 6.0 * active * tokens * len(plain) / sum(b - a for a, b in plain)}
    e2e = {"train_tokens_per_s": tokens * len(steps) / (steps[-1][1] - t0), "setup_s": setup_s}
    failed = sum(1 for *_, loss in steps if not math.isfinite(loss))
    del met
    free_program(st)
    lim = cell.workload["limits"]
    t = time.perf_counter()
    ref = reference(cell, st)
    log(f"reference {time.perf_counter() - t:.1f} s over {len(ref['loss'])} steps")
    got = gaps(st, ref)
    log(f"readings {got}")
    checks = {k: {"value": v, "limit": lim[k]} for k, v in got.items() if k in lim}
    out_trace = None
    if trace:
        read["trace"] = trace
        out_trace = {"busy_s": trace["busy_s"], "window_s": trace["window_s"],
                     "breakdown": {"device_ops": top(trace["by_name"]),
                                   "idle_gaps": top(trace["idle_by_host"])}}
    return Record(e2e, read, checks, attempted=len(steps), failed=failed,
                  memory_peak_bytes=peak, trace=out_trace)


def half_batch(loss_fn):
    """A planted fault: the loss over the first half of the rows only."""
    def half(params, cfg, tokens, labels, *a, **k):
        n = labels.shape[0] // 2
        return loss_fn(params, cfg, None if tokens is None else tokens[:n], labels[:n], *a, **k)
    return half


def limit_readings(cell: Cell, role: str, seed: int) -> Dict[str, float]:
    """The numbers a limit is set from, for one seed: the program's gaps
    (``role`` "program"), the control's (the reference in float8 against
    the float32 one: "control"), or the program's with half of each
    microbatch's rows left out of the loss ("half_batch")."""
    if role == "control":
        st = {"W0": weights.draw(cell.conf, seed, torch.device(cell.device)),
              "data": Data(cell.workload["traffic"], cell.conf["arch"], cell.conf["train"],
                           seed, torch.device(cell.device))}
        return {"control_" + k: v for k, v in gaps(reference(cell, st, "fp8"),
                                                   reference(cell, st)).items()}
    if role == "half_batch":
        loop = importlib.import_module("repro_torch.train.loop")
        saved = loop.loss_fn
        loop.loss_fn = half_batch(saved)
        try:
            st = first_steps(cell, seed)
        finally:
            loop.loss_fn = saved
    else:
        st = first_steps(cell, seed)
    free_program(st)
    t = time.perf_counter()
    ref = reference(cell, st)
    out = {"reference_s": time.perf_counter() - t}
    out.update({(role + "_" if role != "program" else "") + k: v for k, v in gaps(st, ref).items()})
    for kind in ("grad_norm", "delta_norm"):  # the three worst leaves, for the record
        g = leaf_gaps(st[kind], ref[kind], list(ref[kind]))
        out[kind + ".worst"] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
    out["loss"], out["ref_loss"] = st["loss"], ref["loss"]
    return out
