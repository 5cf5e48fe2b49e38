"""BENCHMARK.json against the benchmark's contract, and the harness finding
a cell, a configuration, a traffic kind and a metric added as files."""
import json
import re
import shutil

import pytest

from port_bench_tiny import ROOT, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200


def test_every_cell_reports_enough():
    pairs = set()
    for w in BENCH["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs and w["chips"] == 1
        pairs.add((w["config"], w["traffic"]))
        e2e = [m["name"] for m in harness.metrics_for(BENCH, w["name"], False)]
        layer = harness.metrics_for(BENCH, w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:  # each per-layer metric moves an end-to-end metric its cell reports
            assert m["moves"] in e2e
        spec = json.loads((ROOT / "port_bench/workloads" / f"{w['name']}.json").read_text())
        assert spec["config"] == w["config"]
        assert (ROOT / "port_bench/traffic" / f"{spec['kind']}.py").exists()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for m in BENCH["per_layer"]:
        assert (ROOT / "port_bench/metrics" / f"{m['name']}.py").exists()


def test_a_cell_added_as_files(tmp_path):
    """A new configuration, traffic kind, cell and metric: files and
    BENCHMARK.json entries only, nothing that is there edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "port_bench"
    (pb / "configs/toy.json").write_text(json.dumps({"name": "toy", "size": 3}))
    (pb / "traffic/echo.py").write_text(
        "from port_bench.harness import Record\n"
        "def run(cell):\n"
        "    return Record({'echo_s': cell.conf['size'] * 1.0, 'setup_s': 1.0},\n"
        "                  {'n': cell.workload['traffic']['n']},\n"
        "                  {'exact': {'value': 0, 'limit': 0}}, 1, 0)\n")
    (pb / "workloads/toy.echo.json").write_text(json.dumps(
        {"name": "toy.echo", "config": "toy", "kind": "echo", "why": "a test",
         "traffic": {"n": 7}}))
    (pb / "metrics/echo.n.py").write_text("def read(record):\n    return record.readings['n']\n")
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "port_bench/configs/toy.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy.echo", "config": "toy", "traffic": "echo",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "echo_s", "unit": "s", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["toy.echo"]})
    bench["per_layer"].append({"name": "echo.n", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "echo",
                               "moves": "echo_s", "workloads": ["toy.echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    saved = harness.BENCH_DIR
    harness.BENCH_DIR = pb
    try:
        cell, traffic, b, _ = harness.load_cell(tmp_path, "toy.echo", 5, 1.0, False, "cpu")
        rec = traffic.run(cell)
        e2e = harness.read_metrics(rec, harness.metrics_for(b, "toy.echo", False), False)
        layer = harness.read_metrics(rec, harness.metrics_for(b, "toy.echo", True), True)
    finally:
        harness.BENCH_DIR = saved
    assert e2e == {"echo_s": {"value": 3.0, "unit": "s"}, "setup_s": {"value": 1.0, "unit": "s"}}
    assert layer == {"echo.n": {"value": 7, "unit": "1"}}
    assert rec.correct


def test_result_line_keys_and_checks_last():
    rec = harness.Record({"setup_s": 1.0}, {}, {"gap": {"value": 0.5, "limit": 1.0}}, 3, 0)
    line = harness.result_line(rec, {}, {"platform": "gpu"})
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks" and line["correct"]
    assert not harness.Record({}, {}, {"gap": {"value": 2.0, "limit": 1.0}}, 1, 0).correct
    assert not harness.Record({}, {}, {"n": {"value": 2, "limit": 3, "least": True}}, 1, 0).correct
    assert not harness.Record({}, {}, {"gap": {"value": float("nan"), "limit": 1.0}}, 1, 0).correct


def test_cli_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "jamba.docs", "--seed", "1", "--seconds", "1"]) == 3


@pytest.mark.parametrize("name,found", [("repro.core", True), ("jax.numpy", True),
                                        ("jaxlib", True), ("flax.linen", True),
                                        ("repro_torch.serve", False), ("jaxtyping", False),
                                        ("reprox", False)])
def test_forbidden_modules_compare_whole_top_level_names(name, found, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == found
