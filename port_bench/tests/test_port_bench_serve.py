"""The serving traffic kind at a tiny size on the CPU: the plain reference
agrees with the port, a run comes out correct, and the planted faults and
the float8 control come out not correct."""
import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from port_bench_tiny import ROOT, tiny_cell, tiny_conf
from port_bench import archcfg, weights, work
from port_bench.reference import lm

CELLS = ["jamba.docs"]


@pytest.mark.parametrize("name", ["jamba-v0.1-52b-16L", "mamba2-370m"])
def test_reference_agrees_with_the_port(name):
    from repro_torch.models import transformer as T

    conf = tiny_conf(name, "float32")
    W = weights.draw(conf, 7, torch.device("cpu"))
    cfg = archcfg.port_config(conf["arch"], name)
    model = weights.to_port(cfg, W, torch.float32)
    toks = torch.randint(0, 256, (2, 70), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = T.forward(model, cfg, {"tokens": toks}, mode="train")
        want = lm.forward(W, conf["arch"], toks)
    assert float((got - want).abs().max()) < 1e-4 * float(want.abs().max())


def test_reference_follows_serving_through_the_cache():
    """Prefill then decode ticks in the engine read as one reference pass
    whose decoded tokens are routed alone (f32: the same greedy tokens)."""
    cell, traffic = tiny_cell("jamba.docs")
    srv, out = traffic.serve(cell, 3, 1.0)
    ref = traffic.served_logits(srv, out["check"])
    assert traffic.gap_stats(ref, [r.handle.out for r in out["check"]], "g")["g"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct(name):
    cell, traffic = tiny_cell(name, "bfloat16", trace=True)
    rec = traffic.run(cell)
    assert rec.correct, rec.checks
    assert rec.end_to_end["output_tokens_per_s"] > 0 and rec.readings["tick_ms"]
    assert rec.trace["window_s"] > 0


def _flipped(make):
    """A decode step whose token is altered where it is produced: the
    logits negated, so the worst token comes out first."""
    def make_step(cfg, scfg):
        step = make(cfg, scfg)
        return lambda params, cache, tokens: (lambda lc: (-lc[0], lc[1]))(
            step(params, cache, tokens))
    return make_step


def _frozen(make):
    """A decode step that returns its state (the cache) unchanged."""
    def make_step(cfg, scfg):
        step = make(cfg, scfg)

        def frozen(params, cache, tokens):
            saved = {(s, p, n): t.clone() for s, ps in cache["segments"].items()
                     for p, leaves in ps.items() for n, t in leaves.items()}
            logits, cache = step(params, cache, tokens)
            for (s, p, n), t in saved.items():
                cache["segments"][s][p][n].copy_(t)
            return logits, cache
        return frozen
    return make_step


@pytest.mark.parametrize("fault", [_flipped, _frozen], ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(name, fault, monkeypatch):
    engine = importlib.import_module("repro_torch.serve.engine")
    monkeypatch.setattr(engine, "make_decode_step", fault(engine.make_decode_step))
    cell, traffic = tiny_cell(name, "bfloat16")
    rec = traffic.run(cell)
    assert not rec.correct, rec.checks


def test_the_control_reads_above_the_program():
    cell, traffic = tiny_cell("jamba.docs", "bfloat16")
    got = traffic.limit_readings(cell, "control", 11)
    assert got["control_logit_gap"] > max(got["logit_gap"], 0.0)


def test_the_control_is_not_correct():
    """The float8 control through the run's own checks: its mean gap, the
    number compared, fails the limit where the program's passes.  The tiny
    model's logits spread less than the cell's, so the limit here lies
    between its own readings (16 new tokens, 8 requests judged; seeds 11-18:
    program 0.0001-0.0091, control 0.033-0.079); the cell's limit lies
    between the cell's (PERF.md)."""
    cell, traffic = tiny_cell("jamba.docs", "bfloat16", seconds=8.0)
    cell.workload["traffic"].update(new_tokens=16, check_requests=8, clients=8, slots=8)
    limit = cell.workload["limits"]["mean_logit_gap"] = 0.02
    got = traffic.limit_readings(cell, "control", 11)
    assert got["correct"] and got["logit_gap.mean"] <= limit
    assert not got["control_correct"] and got["control_logit_gap.mean"] > limit


def _tick_server(launched):
    arch = json.loads((ROOT / "port_bench/configs/jamba-v0.1-52b-16L.json").read_text())["arch"]
    kinds = archcfg.layer_kinds(arch)
    return SimpleNamespace(arch=arch, kinds=kinds, ticks=[(0.0, 1.0, [2048], 16)],
                           launched={0: launched(work.tick_work(arch, kinds, [2048], 16))})


@pytest.mark.parametrize("case", ["every_call", "experts_off_the_path", "one_call_short",
                                  "a_family_not_expected"])
def test_the_bound_counts_only_launched_kernels(case):
    """A family launched as often as the tick calls it adds its bound, one
    not launched adds nothing, any other count leaves the bound unread."""
    from port_bench.traffic import serve_closed as traffic

    def launched(want):
        got = {f: calls for f, (calls, _) in want.items()}
        if case == "experts_off_the_path":
            got["experts"] = 0
        elif case == "one_call_short":
            got["ssd"] -= 1
        elif case == "a_family_not_expected":
            got["flash"] += 1
        return got

    srv = _tick_server(launched)
    want = work.tick_work(srv.arch, srv.kinds, [2048], 16)
    bound, seen = traffic.launched_bound_s(srv, range(1))
    full = sum(ms for _, ms in want.values())
    if case == "every_call":
        assert bound == pytest.approx(1e-3 * full, rel=1e-12)
    elif case == "experts_off_the_path":
        assert bound == pytest.approx(1e-3 * (full - want["experts"][1]), rel=1e-12)
    else:
        assert bound is None
    assert seen["ssd"][1] == 14 and seen["experts"][1] == 16 and seen["swiglu"][1] == 16
