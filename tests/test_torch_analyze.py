"""The port's happens-before analyzer (``codegen/analyze.py``) and the
segmented executor's host tables it proves (``codegen/executor.py``:
``plan_tables``, ``plan_access_walk``, ``segment_access_tables``), both
copied from the reference, against the originals on the same plans.

* tables: equal array by array and field by field, for the four builders in
  the five slicings of ``_torch_cnn_cases`` at m = 4, ``buffer_depth`` in
  {1, 2, 4}, with and without ``checkpoint``;
* clean plans (lenet5 in four channel tiles at depths 1-4; the headline,
  grid-sliced inception(64) on 8 workers, at depths 1, 2, 4): the same
  verdict, sync report, per-segment rows and event counts, and the same
  ``validate_plan(deep=True)`` statistics;
* the mutation oracle (``tests/_torch_mutations.py``, the port's copy of
  ``tests/mutations.py``): every class caught on both plans, with the
  reference's hazards on lenet5; the seams that refuse a hazardous plan
  (``validate_plan(deep=True)``, its memo, ``ElasticPlanner``).

Counts, tables and reports must be exactly equal: the analysis is integer
and set logic over the same plans."""
import dataclasses
import functools
import time

import numpy as np
import pytest

import _torch_mutations as mutations
import mutations as jax_mutations
import repro.codegen as jax_codegen
import repro.codegen.analyze as jax_analyze
import repro.codegen.executor as jax_executor
import repro.core as jax_core
import repro.core.costmodel as jax_costmodel
import repro.models.cnn as jax_cnn
import repro.models.slicing as jax_slicing
import repro_torch.codegen as codegen
import repro_torch.codegen.analyze as analyze
import repro_torch.codegen.executor as executor
import repro_torch.codegen.validate as validate_mod
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
import repro_torch.models.cnn as cnn
import repro_torch.models.slicing as slicing
import repro_torch.runtime.elastic as elastic
from _torch_cnn_cases import BUILDERS, SLICINGS, jax_model, torch_model

DEPTHS = (1, 2, 4)


def _pipeline(cnn_mod, slicing_mod, costmodel_mod, codegen_mod, core_mod, config, m=None):
    """(sliced model, its DAG, the coalesced DSH plan) of a named config."""
    if config == "lenet5":
        model, m = cnn_mod.lenet5(28), 4
        factors = slicing_mod.uniform_factors(model, 4)
    elif config == "headline":  # grid-sliced inception(64) on 8 workers
        model, m = cnn_mod.inception_net(64), 8
        base = slicing_mod.uniform_factors(model, 8, spatial=True)
        factors = {k: ((2, 4) if v == (1, 8) else v) for k, v in base.items()}
    sliced = slicing_mod.slice_model(model, factors)
    dag = sliced.to_dag(costmodel_mod.KEYSTONE_CPU, time_unit=1e-6)
    plan = codegen_mod.coalesce_transfer_steps(codegen_mod.build_plan(core_mod.dsh(dag, m), dag))
    return sliced, dag, plan


@functools.lru_cache(maxsize=None)
def _config(config):
    """((reference model, dag, plan), (port model, dag, plan)), plans equal."""
    ref = _pipeline(jax_cnn, jax_slicing, jax_costmodel, jax_codegen, jax_core, config)
    port = _pipeline(cnn, slicing, costmodel, codegen, core, config)
    assert codegen.plan_fingerprint(port[2]) == jax_codegen.plan.plan_fingerprint(ref[2])
    return ref, port


@functools.lru_cache(maxsize=None)
def _case_plans(builder, sl, m=4):
    jm, tm = jax_model(builder, sl), torch_model(builder, sl)
    jdag = jm.to_dag(jax_costmodel.KEYSTONE_CPU, time_unit=1e-6)
    tdag = tm.to_dag(costmodel.KEYSTONE_CPU, time_unit=1e-6)
    jplan = jax_codegen.coalesce_transfer_steps(jax_codegen.build_plan(jax_core.dsh(jdag, m), jdag))
    tplan = codegen.coalesce_transfer_steps(codegen.build_plan(core.dsh(tdag, m), tdag))
    return (jm, jplan), (tm, tplan)


def assert_same(a, b, path="tables"):
    """Equal field by field: numpy arrays by dtype, shape and value,
    dataclasses by class name and fields, containers by order."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, path


def _hazards(report):
    return [dataclasses.astuple(h) for h in report.hazards]


def _same_report(port, ref):
    assert port.ok == ref.ok
    assert _hazards(port) == _hazards(ref)
    assert port.depths == ref.depths
    assert port.sync == ref.sync
    assert port.stats == ref.stats
    assert port.segments == ref.segments
    assert port.summary() == ref.summary()


# --------------------------------------------------------------------------- #
# the segmented executor's host tables
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("sl", SLICINGS)
@pytest.mark.parametrize("builder", BUILDERS)
def test_access_tables_equal(builder, sl, depth):
    (jm, jplan), (tm, tplan) = _case_plans(builder, sl)
    for checkpoint in (True, False):
        ref = jax_executor.segment_access_tables(jplan, jm, buffer_depth=depth,
                                                 checkpoint=checkpoint)
        port = executor.segment_access_tables(tplan, tm, buffer_depth=depth,
                                              checkpoint=checkpoint)
        assert_same(port, ref, f"{builder}/{sl}/depth {depth}/checkpoint {checkpoint}")


def test_waterfill_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        loads = rng.integers(0, 9, size=12)
        lo = int(rng.integers(0, 11))
        hi = int(rng.integers(lo, 12))
        n = int(rng.integers(0, 40))
        got = executor._waterfill(loads, lo, hi, n)
        assert np.array_equal(got, jax_executor._waterfill(loads, lo, hi, n))
        assert int(got.sum()) == n


# --------------------------------------------------------------------------- #
# clean plans: the same proof, the same counts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("config,depths", [("lenet5", (1, 2, 3, 4)), ("headline", (1, 2, 4))])
def test_clean_plan_reports_equal(config, depths):
    (jm, jdag, jplan), (tm, tdag, tplan) = _config(config)
    ref = jax_analyze.analyze_plan(jplan, jdag, jm, depths=depths)
    port = analyze.analyze_plan(tplan, tdag, tm, depths=depths)
    assert port.ok, port.summary()
    assert set(port.stats["per_depth"]) == set(depths)
    assert port.stats["cell_events"] > 0 and port.stats["plan_events"] > 0
    _same_report(port, ref)
    for prop in ("race-free", "donation-safe", "sync-sufficient", "deterministic"):
        assert prop in port.summary()


@pytest.mark.parametrize("config", ["lenet5", "headline"])
def test_model_free_analysis_equal(config):
    (_jm, jdag, jplan), (_tm, tdag, tplan) = _config(config)
    port = analyze.analyze_plan(tplan, tdag)
    assert port.ok and port.depths == () and port.stats["cell_events"] == 0
    _same_report(port, jax_analyze.analyze_plan(jplan, jdag))


@pytest.mark.parametrize("config", ["lenet5", "headline"])
def test_deep_validate_stats_equal(config):
    (jm, jdag, jplan), (tm, tdag, tplan) = _config(config)
    port = codegen.validate_plan(tplan, tdag, model=tm, deep=True, cache=False)
    ref = jax_codegen.validate_plan(jplan, jdag, model=jm, deep=True, cache=False)
    assert port == ref
    assert port["hazards"] == 0 and port["analyzed_events"] > 0


# --------------------------------------------------------------------------- #
# the mutation oracle
# --------------------------------------------------------------------------- #
def _analysis_depths(mut):
    # table tampers target the frame machinery: analyze at a streaming depth
    return (max(mut.min_depth, 2),) if mut.tamper else (1, 2)


def _analyze_mutation(analyze_mod, mut, dag, model):
    return analyze_mod.analyze_plan(mut.plan, dag, model, depths=_analysis_depths(mut),
                                    offsets=mut.offsets, tamper=mut.tamper)


@pytest.mark.parametrize("cls", mutations.MUTATION_CLASSES)
def test_mutation_caught_lenet_as_reference(cls):
    """Caught, with the reference's hazards (kinds and coordinates) on the
    reference's mutation of the same seed."""
    (jm, jdag, jplan), (tm, tdag, tplan) = _config("lenet5")
    mut = mutations.mutate(cls, tplan, tdag, tm, seed=0)
    jmut = jax_mutations.mutate(cls, jplan, jdag, jm, seed=0)
    assert mut is not None and jmut is not None
    assert mut.detail == jmut.detail and mut.offsets == jmut.offsets
    assert codegen.plan_fingerprint(mut.plan) == jax_codegen.plan.plan_fingerprint(jmut.plan)
    port = _analyze_mutation(analyze, mut, tdag, tm)
    assert not port.ok, f"{cls} not caught ({mut.detail})"
    h = port.hazards[0]
    assert h.kind and h.detail and str(h).startswith(f"[{h.kind}]")
    _same_report(port, _analyze_mutation(jax_analyze, jmut, jdag, jm))


@pytest.mark.parametrize("cls", mutations.MUTATION_CLASSES)
def test_mutation_caught_headline(cls):
    _ref, (tm, tdag, tplan) = _config("headline")
    mut = mutations.mutate(cls, tplan, tdag, tm, seed=0)
    assert mut is not None, f"{cls}: the headline plan cannot express the bug"
    port = _analyze_mutation(analyze, mut, tdag, tm)
    assert not port.ok, f"{cls} not caught ({mut.detail})"


def test_deep_validate_refuses_with_coordinates(monkeypatch):
    """A plan-level bug is refused by the structural layer, naming its
    superstep and worker; a table-level bug (one the plan IR cannot
    express, planted in the tables the analyzer reads) by the analyzer, as
    a ``PlanHazardError`` (a ``PlanValidationError``) whose message pins
    the segment and tick."""
    _ref, (tm, tdag, tplan) = _config("lenet5")
    mut = mutations.mutate("misroute_transfer", tplan, tdag, tm, seed=0)
    with pytest.raises(codegen.PlanValidationError) as ei:
        codegen.validate_plan(mut.plan, tdag, model=tm, deep=True, cache=False)
    msg = str(ei.value)
    assert msg.startswith("[superstep ") and "worker" in msg and "'" in msg

    mut = mutations.mutate("mispad_cohort", tplan, tdag, tm, seed=0)
    real = executor.segment_access_tables
    monkeypatch.setattr(executor, "segment_access_tables",
                        lambda *a, **kw: mut.tamper(real(*a, **kw)))
    with pytest.raises(codegen.PlanHazardError) as ei:
        codegen.validate_plan(tplan, tdag, model=tm, deep=True, staging_depths=(2,), cache=False)
    assert isinstance(ei.value, codegen.PlanValidationError)
    assert isinstance(ei.value.report, codegen.AnalysisReport)
    assert ei.value.report.hazards
    assert "segment" in str(ei.value) and "tick" in str(ei.value)


def test_validation_memo_dedups_deep_analysis(monkeypatch):
    _ref, (tm, tdag, tplan) = _config("lenet5")
    calls = {"n": 0}
    real = analyze.analyze_plan

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(analyze, "analyze_plan", counting)
    validate_mod._MEMO.clear()
    codegen.validate_plan(tplan, tdag, model=tm, deep=True)
    assert calls["n"] == 1
    t0 = time.perf_counter()
    codegen.validate_plan(tplan, tdag, model=tm, deep=True)
    assert calls["n"] == 1, "memo miss: the deep analysis ran again"
    assert time.perf_counter() - t0 < 0.05


def test_elastic_planner_refuses_hazardous_replan(monkeypatch):
    """A degraded replan that comes out racy (the planner's build routed
    through the mutation oracle) raises; the honest build ships."""
    _ref, (tm, tdag, tplan) = _config("lenet5")
    mut = mutations.mutate("drop_transfer", tplan, tdag, tm, seed=0)
    planner = elastic.ElasticPlanner(tdag, model=tm)
    sched = core.dsh(tdag, 4)
    monkeypatch.setattr(elastic, "build_plan", lambda s, d, *a, **kw: mut.plan)
    monkeypatch.setattr(elastic, "coalesce_transfer_steps", lambda p: p)
    with pytest.raises(codegen.PlanValidationError):
        planner._finalize(list(range(4)), sched, "remesh")
    monkeypatch.undo()
    assert planner._finalize(list(range(4)), sched, "remesh").plan is not None


def test_depth3_validates():
    """Any staging depth >= 1 validates and analyzes, as in the reference."""
    (jm, jdag, jplan), (tm, tdag, tplan) = _config("lenet5")
    port = codegen.validate_plan(tplan, tdag, model=tm, staging_depths=(3,), cache=False)
    assert port == jax_codegen.validate_plan(jplan, jdag, model=jm, staging_depths=(3,),
                                             cache=False)
    assert analyze.analyze_plan(tplan, tdag, tm, depths=(3,)).ok
