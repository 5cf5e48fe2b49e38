"""The readers of the program's own spans and counters at a tiny size on
the CPU, and the trace's idle gaps named after the span under them."""
import importlib.util
import time

import pytest

from port_bench_tiny import ROOT, tiny_cell
from port_bench.trace import Trace

SERVE = ["engine.admit_ms", "engine.decode_ms", "engine.readback_ms", "moe.fill.docs"]
TRAIN = ["trainer.forward_backward_ms", "trainer.update_ms"]


@pytest.fixture()
def store():
    from repro_torch.runtime import spans

    spans.disable()
    spans.clear()
    yield spans
    spans.clear()


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), ROOT / "port_bench/metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_an_idle_gap_takes_the_name_of_the_span_under_it(store):
    """A span that sleeps through the middle of a CPU trace's window (no
    device work at all, so the window is one gap) names that gap."""
    tr = Trace()
    tr.start()
    with store.span("test.sleep"):
        time.sleep(0.2)
    out = tr.stop()
    assert max(out["idle_by_host"].items(), key=lambda kv: kv[1])[0] == "test.sleep"
    assert "python" not in out["idle_by_host"]


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_the_serving_readers(store, trace):
    cell, traffic = tiny_cell("jamba.docs", "bfloat16", trace=trace)
    rec = traffic.run(cell)
    got = {name: reader(name)(rec) for name in SERVE + TRAIN}
    if not trace:
        assert all(v is None for v in got.values()), got
        return
    assert all(got[name] is not None for name in SERVE), got
    assert got["trainer.forward_backward_ms"] is None and got["trainer.update_ms"] is None
    snap = store.snapshot()
    ticks = [s for s in snap["spans"] if s["name"] == "engine.tick"]
    assert len(ticks) == cell.workload["traffic"]["trace"]["ticks"]
    tick_ms = sum(s["ms"] for s in ticks) / len(ticks)
    assert got["engine.admit_ms"] + got["engine.decode_ms"] <= tick_ms
    assert got["engine.readback_ms"] < got["engine.admit_ms"] + got["engine.decode_ms"]
    c = snap["counters"]
    assert 0 < got["moe.fill.docs"] <= 100
    assert got["moe.fill.docs"] == pytest.approx(
        100 * (c["moe.kept.prefill"] + c["moe.kept.decode"])
        / (c["moe.rows.prefill"] + c["moe.rows.decode"]))


@pytest.mark.parametrize("trace", [True, False], ids=["traced", "untraced"])
def test_the_training_readers(store, trace):
    """On the CPU a span has no CUDA events: the trainer's readers read
    nothing, though the traced step's spans are there."""
    cell, traffic = tiny_cell("mamba2.train", "bfloat16", trace=trace)
    rec = traffic.run(cell)
    got = {name: reader(name)(rec) for name in SERVE + TRAIN}
    assert all(v is None for v in got.values()), got
    names = {s["name"] for s in store.snapshot()["spans"]}
    assert ({"train.step", "train.forward", "train.backward", "train.update"} <= names) == trace
