"""The port's spans and counters (``repro_torch.runtime.spans``) on the CPU.

Off, a span is the shared no-op and nothing records.  On, under a CPU
``torch.profiler``, each span is a host event of its name and the store
keeps its parent; an engine tick, the MoE dispatches and a train step
record the trees ``serve/engine.py``, ``models/`` and ``train/loop.py``
name, and give the same tokens and the same bits as with spans off.
"""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models import layers
from repro_torch.models.moe_scatter import moe_chunk_scatter
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime import spans
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.loop import TrainConfig, make_train_step

PROMPTS = [[1, 2, 3], [9, 8, 7, 6, 5, 4, 3, 2, 1], [4, 4], [5, 1, 2, 3, 4, 40, 41]]


@pytest.fixture(autouse=True)
def empty_store():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _model(arch, seed=0):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    return cfg, init_params(cfg, gen, device="cpu", dtype=torch.float32)


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing():
    assert not spans.active()
    assert spans.span("a") is spans.span("b", rid=3, device=True)
    with spans.span("a"):
        spans.count("c", 5)
        spans.count_device("d", torch.tensor(2))
        spans.mark("e", time.perf_counter_ns())
    snap = spans.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    assert set(snap["launches"]) == {"flash_attention", "swiglu_matmul", "ssd_scan", "causal_conv"}


def test_spans_are_host_events_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.active()
        with spans.span("t.outer", rid=7, n=3):
            with spans.span("t.inner"):
                torch.ones(4).sum()
            with spans.span("t.second"):
                pass
        spans.count("t.n", 2)
        spans.count("t.n", 3)
        spans.count_device("t.dev", torch.tensor(4))
        spans.count_device("t.dev", torch.tensor(1))
    assert not spans.active()
    with spans.span("t.after"):
        pass
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("t.")]
    assert sorted(e.name() for e in events) == ["t.inner", "t.outer", "t.second"]
    assert all(e.device_type() == torch.autograd.DeviceType.CPU for e in events)
    snap = spans.snapshot()
    by = {s["name"]: s for s in snap["spans"]}
    assert list(by) == ["t.outer", "t.inner", "t.second"]
    assert by["t.outer"]["parent"] == 0
    assert by["t.inner"]["parent"] == by["t.second"]["parent"] == by["t.outer"]["id"]
    assert by["t.outer"]["rid"] == 7 and by["t.outer"]["n"] == 3
    assert by["t.outer"]["start_ns"] <= by["t.inner"]["start_ns"] <= by["t.inner"]["end_ns"]
    assert by["t.second"]["end_ns"] <= by["t.outer"]["end_ns"]
    assert by["t.outer"]["device_ms"] is None  # no CUDA events on the CPU
    assert snap["counters"] == {"t.n": 5, "t.dev": 5}
    spans.clear()
    assert spans.snapshot()["spans"] == []


def test_the_switch_records_without_a_profiler():
    spans.enable()
    t0 = time.perf_counter_ns()
    with spans.span("s.a"):
        spans.mark("s.wait", t0, rid=1)
    spans.disable()
    with spans.span("s.off"):
        pass
    names = [(s["name"], s["rid"], s["parent"]) for s in spans.snapshot()["spans"]]
    assert names == [("s.wait", 1, 0), ("s.a", None, 0)]


def test_a_span_on_another_thread_keeps_its_own_stack():
    import threading

    spans.enable()
    with spans.span("m.main"):
        th = threading.Thread(target=lambda: spans.span("m.thread").__enter__().__exit__())
        th.start()
        th.join()
    by = {s["name"]: s for s in spans.snapshot()["spans"]}
    assert by["m.thread"]["parent"] == 0 and by["m.thread"]["thread"] != by["m.main"]["thread"]


def _serve(arch, on, impl="einsum"):
    cfg, model = _model(arch)
    eng = Engine(cfg, model, ServeConfig(max_seq=64, slots=2, moe_impl=impl), device="cpu")
    reqs = [eng.submit(p, max_new=4) for p in PROMPTS]
    if on:
        spans.enable()
    eng.run_until_done()
    spans.disable()
    return [r.out for r in reqs], [r.rid for r in reqs]


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_engine_tick_tree(impl):
    off, _ = _serve("jamba-v0.1-52b", False, impl)
    assert spans.snapshot()["spans"] == []
    on, rids = _serve("jamba-v0.1-52b", True, impl)
    assert on == off  # the same tokens, bit for bit
    snap = spans.snapshot()
    by = _by_name(snap)
    ids = {s["id"]: s for s in snap["spans"]}
    parent = {s["id"]: ids.get(s["parent"], {"name": None})["name"] for s in snap["spans"]}
    ticks = by["engine.tick"]
    assert all(s["parent"] == 0 for s in ticks)
    assert len(by["engine.admit"]) == len(ticks)
    assert len(by["engine.decode"]) == len(ticks)  # every tick here has a live slot
    for name, up in [("engine.admit", "engine.tick"), ("engine.decode", "engine.tick"),
                     ("engine.prefill", "engine.admit"), ("engine.first_token", "engine.admit"),
                     ("engine.splice", "engine.admit"), ("engine.decode_step", "engine.decode"),
                     ("engine.readback", "engine.decode")]:
        assert {parent[s["id"]] for s in by[name]} == {up}, name
    # one prefill, first token, splice and queue a request, sharing its rid
    for name in ("engine.prefill", "engine.first_token", "engine.splice", "engine.queue"):
        assert sorted(s["rid"] for s in by[name]) == rids, name
    assert {s["rid"]: s["n"] for s in by["engine.prefill"]} == dict(
        zip(rids, map(len, PROMPTS)))
    assert all(s["parent"] == 0 for s in by["engine.queue"])
    # the model's spans: each forward's embed, per layer mixer and FFN, unembed
    cfg = get_config("jamba-v0.1-52b").reduced()
    forwards = len(PROMPTS) + len(ticks)
    assert len(by["model.embed"]) == len(by["model.unembed"]) == forwards
    assert len(by["model.attn"]) == forwards * cfg.n_layers // cfg.hybrid.attn_period
    assert len(by["model.ssm"]) == forwards * (cfg.n_layers - cfg.n_layers // 4)
    assert len(by["model.moe"]) == len(by["model.mlp"]) == forwards * cfg.n_layers // 2
    assert len(by["model.layer"]) == forwards * cfg.n_layers
    assert {parent[s["id"]] for s in by["model.layer"]} == {"engine.prefill", "engine.decode_step"}
    for name in ("model.attn", "model.ssm", "model.mlp", "model.moe"):
        assert {parent[s["id"]] for s in by[name]} == {"model.layer"}, name
    for part in ("route", "dispatch", "experts", "combine"):
        assert {parent[s["id"]] for s in by["model.moe." + part]} == {"model.moe"}
        assert len(by["model.moe." + part]) == len(by["model.moe"])
    c = snap["counters"]
    assert c["moe.routed.prefill"] == cfg.moe.top_k * sum(map(len, PROMPTS)) * 2  # 2 MoE layers
    assert c["moe.routed.decode"] == cfg.moe.top_k * 2 * len(ticks) * 2  # 2 slots
    assert 0 < c["moe.kept.prefill"] <= c["moe.routed.prefill"]


def _direct_count(p, m, x):
    """(rows, routed, kept) of one dispatch over x [B, S, D], counted from
    ``moe_route`` token by token in arrival order."""
    B, S, D = x.shape
    s = min(m.router_chunk, S)
    groups = -(-S // s)
    xp = torch.nn.functional.pad(x, (0, 0, 0, groups * s - S)).reshape(-1, s, D)
    _, idx = layers.moe_route(p, m, xp)
    C = layers.moe_capacity(m, s)
    kept = 0
    for g, choices in enumerate(idx.tolist()):
        seen = [0] * m.n_experts
        for t, ks in enumerate(choices):
            for e in ks:
                seen[e] += 1
                kept += seen[e] <= C and (g % groups) * s + t < S
    return m.n_experts * B * groups * C, B * S * m.top_k, kept


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("S,biased", [(77, False), (77, True), (32, True), (1, False)])
def test_moe_counters_equal_a_direct_count(impl, S, biased):
    """77 tokens: three router chunks of 32, the last padded; a router
    biased toward expert 0 overflows its capacity (drops); 1 token: decode."""
    cfg, model = _model("jamba-v0.1-52b")
    m = cfg.moe
    p = {k: v.detach().clone() for k, v in model.layers[1].moe.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(S).standard_normal((3, S, cfg.d_model),
                                                                 dtype=np.float32))
    if biased:
        x[..., 0] = 4.0
        p["router"][0, 0] = 10.0
    rows, routed, kept = _direct_count(p, m, x)
    if biased:
        assert kept < routed
    phase = "decode" if S == 1 else "prefill"
    want = layers.moe_layer(p, cfg, x, impl=impl, mode=phase)
    assert spans.snapshot()["counters"] == {}
    spans.enable()
    got = layers.moe_layer(p, cfg, x, impl=impl, mode=phase)
    layers.moe_layer(p, cfg, x, impl=impl, mode="train")  # not counted
    spans.disable()
    assert torch.equal(got, want)
    c = spans.snapshot()["counters"]
    assert c == {f"moe.rows.{phase}": rows, f"moe.routed.{phase}": routed,
                 f"moe.kept.{phase}": kept}


def test_the_chunk_dispatches_count_alike():
    cfg, model = _model("jamba-v0.1-52b", seed=3)
    p = {k: v.detach() for k, v in model.layers[3].moe.named_parameters()}
    xc = torch.randn(4, 32, cfg.d_model, generator=torch.Generator().manual_seed(1))
    counts = []
    for fn in (layers._moe_chunk_einsum, moe_chunk_scatter):
        spans.clear()
        spans.enable()
        fn(p, cfg.moe, xc, ("prefill", 100))
        spans.disable()
        counts.append(spans.snapshot()["counters"])
    assert counts[0] == counts[1] and counts[0]["moe.routed.prefill"] == 100 * cfg.moe.top_k


@pytest.mark.parametrize("arch,micro", [("mamba2-370m", 2), ("jamba-v0.1-52b", 1)])
def test_a_train_step_is_bit_for_bit_with_spans_on(arch, micro):
    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(microbatches=micro, remat=True, optim=AdamWConfig(warmup_steps=1))
    toks = torch.randint(0, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    states = []
    for on in (False, True):
        _, model = _model(arch)
        opt = adamw_init(dict(model.named_parameters()), tcfg.optim)
        if on:
            spans.enable()
        model, opt, met = make_train_step(cfg, tcfg)(model, opt, batch)
        spans.disable()
        states.append((dict(model.named_parameters()), opt, met))
    (p0, o0, m0), (p1, o1, m1) = states
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(o0[kind][k], o1[kind][k]) for kind in ("m", "v") for k in p0)
    assert torch.equal(o0["step"], o1["step"]) and torch.equal(m0["loss"], m1["loss"])
    snap = spans.snapshot()
    by = _by_name(snap)
    ids = {s["id"]: s for s in snap["spans"]}
    parent = {s["id"]: ids.get(s["parent"], {"name": None})["name"] for s in snap["spans"]}
    assert len(by["train.step"]) == 1 and len(by["train.update"]) == 1
    assert len(by["train.microbatch"]) == micro
    for name in ("train.forward", "train.backward"):
        assert len(by[name]) == micro and {parent[s["id"]] for s in by[name]} == {
            "train.microbatch"}
    assert {parent[s["id"]] for s in by["train.microbatch"]} == {"train.step"}
    assert parent[by["train.update"][0]["id"]] == "train.step"
    acc = by.get("train.accumulate", [])
    assert len(acc) == (micro + 1 if micro > 1 else 0)
    # remat recomputes each layer in the backward: layer spans under both
    assert {parent[s["id"]] for s in by["model.layer"]} == {"train.forward", "train.backward"}
    assert len(by["model.layer"]) == 2 * micro * cfg.n_layers
    assert all(s["device_ms"] is None for s in snap["spans"])
    assert "moe.rows.prefill" not in snap["counters"]
