"""The port's copies of the host logic against the JAX package's originals:
layer specs and slicing, task DAGs, cost models, ISH/DSH schedules, plans
(``build_plan``, ``coalesce_transfer_steps``), ``validate_plan``,
``render_pseudo_c``, random DAGs and branch and bound.  The copies must give
the same schedules and plans: compared by value, by ``plan_fingerprint``
and by makespan, for the four builders whole and in each slicing, at
m in {2, 4, 8}."""
import dataclasses

import pytest

import repro.codegen as jax_codegen
import repro.core as jax_core
import repro.core.costmodel as jax_costmodel
import repro.models.slicing as jax_slicing
import repro_torch.codegen as codegen
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
import repro_torch.models.slicing as slicing
from repro.codegen.plan import plan_fingerprint as jax_fingerprint
from _torch_cnn_cases import BUILDERS, SLICINGS, jax_model, torch_model


def _specs(model):
    return [(l.name, l.op, l.inputs, tuple(l.out_shape), dict(l.attrs)) for l in model.layers]


def _dag(dag):
    return (dag.nodes, dag.edges, dict(dag.t), dict(dag.w),
            {k: dict(v) for k, v in dag.meta.items()})


def _instances(schedule):
    return [(i.node, i.worker, i.start) for i in schedule.instances]


@pytest.mark.parametrize("sl", SLICINGS)
@pytest.mark.parametrize("builder", BUILDERS)
def test_models_and_dags_equal(builder, sl):
    jm, tm = jax_model(builder, sl), torch_model(builder, sl)
    assert tm.name == jm.name
    assert _specs(tm) == _specs(jm)
    for hw in ("KEYSTONE_CPU", "TPU_V5E"):
        assert _dag(tm.to_dag(getattr(costmodel, hw), time_unit=1e-6)) == \
            _dag(jm.to_dag(getattr(jax_costmodel, hw), time_unit=1e-6))


@pytest.mark.parametrize("builder", BUILDERS)
def test_slice_factors_equal(builder):
    jm, tm = jax_model(builder), torch_model(builder)
    assert slicing.choose_slice_factors(tm, costmodel.KEYSTONE_CPU) == \
        jax_slicing.choose_slice_factors(jm, jax_costmodel.KEYSTONE_CPU)
    for n in (2, 3, 8):
        for spatial in (False, True):
            assert slicing.uniform_factors(tm, n, spatial=spatial) == \
                jax_slicing.uniform_factors(jm, n, spatial=spatial)
    assert slicing.slicing_summary(tm, torch_model(builder, "grid")) == \
        jax_slicing.slicing_summary(jm, jax_model(builder, "grid"))


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("sl", SLICINGS)
@pytest.mark.parametrize("builder", BUILDERS)
def test_schedules_and_plans_equal(builder, sl, m):
    jm, tm = jax_model(builder, sl), torch_model(builder, sl)
    jdag = jm.to_dag(jax_costmodel.KEYSTONE_CPU, time_unit=1e-6)
    tdag = tm.to_dag(costmodel.KEYSTONE_CPU, time_unit=1e-6)
    for name in ("ish", "dsh"):
        js, ts = getattr(jax_core, name)(jdag, m), getattr(core, name)(tdag, m)
        assert _instances(ts) == _instances(js), name
        assert ts.makespan(tdag) == js.makespan(jdag)
        core.validate(ts, tdag)
        jp, tp = jax_codegen.build_plan(js, jdag), codegen.build_plan(ts, tdag)
        assert codegen.plan_fingerprint(tp) == jax_fingerprint(jp)
        assert tp.makespan == jp.makespan
        assert dataclasses.astuple(tp) == dataclasses.astuple(jp)  # field by field
        jc, tc = jax_codegen.coalesce_transfer_steps(jp), codegen.coalesce_transfer_steps(tp)
        assert codegen.plan_fingerprint(tc) == jax_fingerprint(jc)
        assert codegen.validate_plan(tp, tdag, tm, cache=False) == \
            jax_codegen.validate_plan(jp, jdag, jm, cache=False)
        assert codegen.render_pseudo_c(tp) == jax_codegen.render_pseudo_c(jp)
        assert codegen.plan_summary(tp, tdag) == jax_codegen.plan_summary(jp, jdag)


def test_validate_plan_rejects_what_the_reference_rejects():
    """A plan with a transfer dropped fails both validators, with the same
    message."""
    jm, tm = jax_model("inception", "grid"), torch_model("inception", "grid")
    jdag = jm.to_dag(jax_costmodel.KEYSTONE_CPU, time_unit=1e-6)
    tdag = tm.to_dag(costmodel.KEYSTONE_CPU, time_unit=1e-6)
    plans = []
    for cd, cr, dag in ((jax_codegen, jax_core, jdag), (codegen, core, tdag)):
        plan = cd.build_plan(cr.dsh(dag, 4), dag)
        i = next(i for i, s in enumerate(plan.steps) if s.transfers)
        step = plan.steps[i]
        broken = dataclasses.replace(step, transfers=step.transfers[1:])
        plans.append(dataclasses.replace(
            plan, steps=plan.steps[:i] + (broken,) + plan.steps[i + 1:]))
    with pytest.raises(jax_codegen.PlanValidationError) as jerr:
        jax_codegen.validate_plan(plans[0], jdag, jm, cache=False)
    with pytest.raises(codegen.PlanValidationError) as terr:
        codegen.validate_plan(plans[1], tdag, tm, cache=False)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(NotImplementedError, match="analyzer"):
        codegen.validate_plan(plans[1], tdag, deep=True)


def test_cost_models_equal():
    for hw in ("KEYSTONE_CPU", "TPU_V5E"):
        assert dataclasses.asdict(getattr(costmodel, hw)) == \
            dataclasses.asdict(getattr(jax_costmodel, hw))


def test_core_exports_equal():
    assert core.__all__ == jax_core.__all__
    assert set(jax_codegen.__all__) <= set(codegen.__all__)


@pytest.mark.parametrize("n,dens,seed", [(10, 0.2, 0), (30, 0.1, 1), (60, 0.05, 2)])
def test_random_dags_and_list_schedules_equal(n, dens, seed):
    jd, td = jax_core.random_dag(n, dens, seed=seed), core.random_dag(n, dens, seed=seed)
    assert _dag(td) == _dag(jd)
    assert core.density(td) == jax_core.density(jd)
    for m in (2, 4):
        for name in ("ish", "dsh"):
            assert _instances(getattr(core, name)(td, m)) == \
                _instances(getattr(jax_core, name)(jd, m))


def test_branch_and_bound_equal():
    """On DAGs small enough that the search ends well inside its budget, the
    copy explores the same nodes and returns the same schedule."""
    for seed in (0, 1):
        jd, td = jax_core.random_dag(8, 0.3, seed=seed), core.random_dag(8, 0.3, seed=seed)
        jr = jax_core.branch_and_bound(jd, 2, timeout_s=30)
        tr = core.branch_and_bound(td, 2, timeout_s=30)
        assert jr.optimal and tr.optimal
        assert (tr.makespan, tr.nodes_explored, tr.from_seed) == \
            (jr.makespan, jr.nodes_explored, jr.from_seed)
        assert _instances(tr.schedule) == _instances(jr.schedule)
