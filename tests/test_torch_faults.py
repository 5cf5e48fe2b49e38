"""The port's fault runner and elastic planner (``repro_torch.runtime``)
against the reference's (``repro.runtime``), on the scenarios of
``tests/test_faults.py`` and the planner scenarios of
``tests/test_train_serve_elastic.py`` that need no trainer.

Both packages get the same plans (equal by ``plan_fingerprint``), the same
weights and inputs (numpy, seeded) and the same fault campaigns.  Outcomes,
injections, monitor state, migration statistics, replans and certificates
must be equal; snapshots and outputs agree to ``rtol = atol = 1e-5`` (f32,
the same ops in another library), and outputs to the sequential run to the
reference test's 1e-4."""
import dataclasses
import functools
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codegen as jax_codegen
import repro.codegen.plan as jax_plan
import repro.core as jax_core
import repro.core.costmodel as jax_costmodel
import repro.models.cnn as jax_cnn
import repro.models.slicing as jax_slicing
import repro.runtime as jax_runtime
import repro.runtime.elastic as jax_elastic
import repro.runtime.faults as jax_faults
import repro_torch.codegen as codegen
import repro_torch.codegen.plan as plan_mod
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
import repro_torch.models.cnn as cnn
import repro_torch.models.slicing as slicing
import repro_torch.runtime as runtime
import repro_torch.runtime.elastic as elastic
import repro_torch.runtime.faults as faults
from _torch_cnn_cases import jax_model, numpy_params_of, torch_model
from repro_torch.convert import cnn_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_TOL = dict(rtol=1e-4, atol=1e-4)
REF = SimpleNamespace(cnn=jax_cnn, slicing=jax_slicing, costmodel=jax_costmodel,
                      codegen=jax_codegen, plan=jax_plan, core=jax_core, runtime=jax_runtime,
                      elastic=jax_elastic, faults=jax_faults)
PORT = SimpleNamespace(cnn=cnn, slicing=slicing, costmodel=costmodel, codegen=codegen,
                       plan=plan_mod, core=core, runtime=runtime, elastic=elastic,
                       faults=faults)


def grid_factors(slicing_mod, model, n=4):
    f = slicing_mod.uniform_factors(model, n, spatial=True)
    return {k: ((2, n // 2) if v == (1, n) else v) for k, v in f.items()}


# (model, factors) of tests/test_faults.py, by name
MODELS = {"lenet5": lambda c: c.lenet5(), "inception": lambda c: c.inception_net(64)}
FACTORS = {
    "channel": lambda s, m: s.uniform_factors(m, 4),
    "rows": lambda s, m: s.uniform_factors(m, 4, spatial=True),
    "grid": grid_factors,
    "grid8": lambda s, m: grid_factors(s, m, 8),
}


@functools.lru_cache(maxsize=None)
def _sliced(model_name, factors_name, m):
    """Per package: (model, sliced model, dag, coalesced DSH plan, params, x);
    plus the reference's sequential output of the unsliced model."""
    out = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        model = MODELS[model_name](pkg.cnn)
        sliced = pkg.slicing.slice_model(model, FACTORS[factors_name](pkg.slicing, model))
        dag = sliced.to_dag(pkg.costmodel.KEYSTONE_CPU, time_unit=1e-6)
        plan = pkg.codegen.coalesce_transfer_steps(pkg.codegen.build_plan(pkg.core.dsh(dag, m), dag))
        out[name] = SimpleNamespace(model=model, sliced=sliced, dag=dag, plan=plan)
    assert codegen.plan_fingerprint(out["port"].plan) == jax_plan.plan_fingerprint(out["ref"].plan)
    pnp = numpy_params_of(out["ref"].model)
    x = np.random.default_rng(1).standard_normal(
        (1, *out["ref"].model.layers[0].out_shape)).astype(np.float32)
    out["ref"].params = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
    out["ref"].x = jnp.asarray(x)
    out["port"].params = cnn_params_from_numpy(pnp, device="cpu")
    out["port"].x = torch.from_numpy(x)
    seq = np.asarray(jax_cnn.run_sequential(out["ref"].model, out["ref"].params, out["ref"].x))
    return out["ref"], out["port"], seq


def _events(plan):
    return [dataclasses.astuple(e) for e in plan.events]


def assert_same_outcome(port, ref):
    assert (port.status, port.step) == (ref.status, ref.step)
    assert (port.fault is None) == (ref.fault is None)
    if ref.fault is not None:
        assert dataclasses.astuple(port.fault) == dataclasses.astuple(ref.fault)
    assert port.retransmitted_bytes == ref.retransmitted_bytes
    assert port.straggled == ref.straggled
    assert list(port.snapshots) == list(ref.snapshots)
    for k, snap in ref.snapshots.items():
        assert len(port.snapshots[k]) == len(snap)
        for got, want in zip(port.snapshots[k], snap):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"snapshot {k}")
    if ref.output is None:
        assert port.output is None
    else:
        assert isinstance(port.output, np.ndarray)
        np.testing.assert_allclose(port.output, np.asarray(ref.output), **TOL)


def _monitor_state(mon):
    return (mon.now, [(w.worker_id, w.last_heartbeat, w.step_times, w.timings, w.alive,
                       w.straggler) for w in mon.workers.values()])


def _run_both(ref, port, **kw):
    """run_with_faults in both packages; ``monitor=n`` gives each a fresh
    ``HealthMonitor(n, heartbeat_timeout=1e9)`` and its own dag."""
    outs, mons = [], []
    for pkg, case in ((REF, ref), (PORT, port)):
        args = dict(kw)
        if "faults" in args:
            args["faults"] = pkg.faults.FaultPlan(
                events=tuple(pkg.faults.FaultEvent(*e) for e in kw["faults"]))
        if "monitor" in args:
            args["monitor"] = pkg.elastic.HealthMonitor(kw["monitor"], heartbeat_timeout=1e9)
            args["dag"] = case.dag
            mons.append(args["monitor"])
        layout = pkg.faults._plan_layout(case.plan, case.sliced)
        outs.append(pkg.faults.run_with_faults(case.plan, case.sliced, case.params, case.x,
                                               layout, **args))
    assert_same_outcome(outs[1], outs[0])
    if mons:
        assert _monitor_state(mons[1]) == _monitor_state(mons[0])
    return outs[1]


# --------------------------------------------------------------------------- #
# fault campaigns
# --------------------------------------------------------------------------- #
class TestFaultPlan:
    @pytest.mark.parametrize("n_workers,n_steps,p_kill", [(8, 20, 0.15), (4, 30, 0.15),
                                                          (8, 16, 0.0)])
    def test_random_campaigns_equal_reference(self, n_workers, n_steps, p_kill):
        for seed in range(50):
            a = faults.FaultPlan.random(n_workers, n_steps, seed=seed, p_kill=p_kill)
            b = jax_faults.FaultPlan.random(n_workers, n_steps, seed=seed, p_kill=p_kill)
            assert _events(a) == _events(b) and a.seed == b.seed == seed
            assert a == faults.FaultPlan.random(n_workers, n_steps, seed=seed, p_kill=p_kill)

    def test_kill_ends_campaign(self):
        for s in range(50):
            plan = faults.FaultPlan.random(4, 30, seed=s)
            kills = [e for e in plan.events if e.kind == "kill"]
            if kills:
                assert plan.events[-1] == kills[0] == plan.first_kill()

    def test_at_filters_by_step(self):
        plan = faults.FaultPlan(events=(
            faults.FaultEvent("straggle", 1, 0, 2.0),
            faults.FaultEvent("drop_round", 1, 2),
            faults.FaultEvent("kill", 3, 1),
        ))
        assert len(plan.at(1)) == 2 and plan.at(2) == ()
        assert plan.first_kill().step == 3
        assert faults.FAULT_KINDS == jax_faults.FAULT_KINDS

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultEvent("meteor", 0, 0)

    def test_exports_equal(self):
        assert runtime.__all__ == jax_runtime.__all__


# --------------------------------------------------------------------------- #
# the superstep runner
# --------------------------------------------------------------------------- #
class TestRunWithFaults:
    def _case(self):
        return _sliced("lenet5", "channel", 4)

    def test_no_faults_matches_reference(self):
        ref, port, seq = self._case()
        out = _run_both(ref, port)
        assert out.status == "ok" and list(out.snapshots) == [len(port.plan.steps)]
        np.testing.assert_allclose(out.output, seq, **SEQ_TOL)

    def test_kill_returns_entering_barrier(self):
        ref, port, _ = self._case()
        out = _run_both(ref, port, faults=[("kill", 2, 1)])
        assert out.status == "killed" and out.step == 2
        assert out.output is None and out.fault.worker == 1
        layout = faults._plan_layout(port.plan, port.sliced)
        assert len(out.snapshot) == 4
        assert all(b.shape == (1, layout.total) for b in out.snapshot)

    def test_straggle_feeds_monitor_as_reference(self):
        ref, port, seq = self._case()
        out = _run_both(ref, port, faults=[("straggle", 0, 2, 8.0)], monitor=4)
        assert out.status == "ok" and out.straggled == {2: 8.0}
        np.testing.assert_allclose(out.output, seq, **SEQ_TOL)

    def test_drop_round_bills_retransmission(self):
        ref, port, seq = self._case()
        step = next(i for i, s in enumerate(port.plan.steps) if s.transfers)
        out = _run_both(ref, port, faults=[("drop_round", step, 0)])
        layout = faults._plan_layout(port.plan, port.sliced)
        out_bytes = {n: layout.size(n) * 4.0 for n in layout.offsets}
        assert out.retransmitted_bytes == faults._round_bytes(port.plan.steps[step], out_bytes) > 0
        np.testing.assert_allclose(out.output, seq, **SEQ_TOL)

    def test_keep_snapshots_every_barrier(self):
        ref, port, _ = _sliced("inception", "grid", 4)
        out = _run_both(ref, port, keep_snapshots=True,
                        faults=[("straggle", 1, 3, 3.0), ("drop_round", 2, 1)], monitor=4)
        assert list(out.snapshots) == list(range(len(port.plan.steps) + 1))

    def test_worker_ids_map_onto_the_fleet(self):
        """A 3-worker plan reporting to a 4-worker monitor as workers 0, 1, 3."""
        ref, port, _ = _sliced("lenet5", "rows", 3)
        mons = []
        for pkg, case in ((REF, ref), (PORT, port)):
            mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=1e9)
            layout = pkg.faults._plan_layout(case.plan, case.sliced)
            pkg.faults.run_with_faults(case.plan, case.sliced, case.params, case.x, layout,
                                       monitor=mon, dag=case.dag, worker_ids=(0, 1, 3))
            mons.append(mon)
        assert _monitor_state(mons[1]) == _monitor_state(mons[0])
        assert mons[1].workers[2].timings == [] and mons[1].workers[3].timings

    @staticmethod
    def _hand_plan(rounds):
        """lenet5 at batch 2 on a hand-built 3-worker plan: worker 0
        computes conv1 (the sink), then one superstep per round of
        ``(src, dst, box)`` transfers of conv1; both packages, every barrier
        kept.  Returns the port's outcome and conv1 per worker at the end."""
        outs = []
        for pkg in (REF, PORT):
            model = pkg.cnn.lenet5()
            Transfer, Superstep = pkg.plan.Transfer, pkg.plan.Superstep
            steps = tuple(
                Superstep(compute=((("input", "conv1") if i == 0 else ()), (), ()),
                          transfers=tuple(Transfer("conv1", *t) for t in r))
                for i, r in enumerate(rounds))
            plan = pkg.plan.ExecutionPlan(n_workers=3, steps=steps, makespan=0.0, sink="conv1",
                                          sink_worker=0)
            layout = pkg.plan.RegisterLayout.of(
                plan, {l.name: tuple(l.out_shape) for l in model.layers})
            pnp = numpy_params_of(jax_cnn.lenet5())
            x = np.random.default_rng(1).standard_normal((2, 28, 28, 1)).astype(np.float32)
            if pkg is REF:
                params = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
                x = jnp.asarray(x)
            else:
                params, x = cnn_params_from_numpy(pnp, device="cpu"), torch.from_numpy(x)
            outs.append(pkg.faults.run_with_faults(plan, model, params, x, layout,
                                                   keep_snapshots=True))
        assert_same_outcome(outs[1], outs[0])
        off, n = layout.offsets["conv1"], layout.size("conv1")
        last = outs[1].snapshots[len(rounds)]
        return outs[1], [b[:, off:off + n].reshape(2, 28, 28, -1) for b in last]

    def test_whole_then_window_transfer_does_not_alias(self):
        """Worker 1 receives conv1 whole from worker 0, then a window of it
        from worker 2, which holds only rows 0-4 (zeros below).  The window
        lands in worker 1's copy: worker 0's register, the sink, keeps its
        rows 4-8.  A destination aliasing its source would zero them."""
        out, (w0, w1, _w2) = self._hand_plan([[(0, 1, None), (0, 2, ((0, 4),))],
                                               [(2, 1, ((0, 8),))]])
        assert np.abs(w0[:, 4:8]).max() > 0 and np.abs(w1[:, 4:8]).max() == 0
        np.testing.assert_array_equal(w0[:, :4], w1[:, :4])
        np.testing.assert_array_equal(out.output, w0)

    def test_round_reads_pre_round_values(self):
        """In one round, worker 1 receives rows 4-8 of conv1 and forwards
        its register to worker 2: worker 2 gets worker 1's value from before
        the round (rows 0-4 only), whatever the order of the transfers."""
        _out, (w0, w1, w2) = self._hand_plan([[(0, 1, ((0, 4),))],
                                               [(0, 1, ((4, 8),)), (1, 2, None)]])
        np.testing.assert_array_equal(w1[:, :8], w0[:, :8])
        np.testing.assert_array_equal(w2[:, :4], w0[:, :4])
        assert np.abs(w0[:, 4:8]).max() > 0 and np.abs(w2[:, 4:]).max() == 0


# --------------------------------------------------------------------------- #
# kill anywhere, migrate, resume
# --------------------------------------------------------------------------- #
class TestMigrateResumeProperty:
    CASES = ["lenet5-channel", "lenet5-rows", "lenet5-grid", "inception-channel",
             "inception-grid"]

    @pytest.mark.parametrize("case", CASES)
    def test_kill_resume_as_reference(self, case):
        m = 4
        ref, port, seq = _sliced(*case.split("-"), m)
        n = len(port.plan.steps)
        rng = np.random.default_rng(7)
        steps = sorted({1, n // 2, n - 1, int(rng.integers(1, n))})
        news = [pkg.codegen.coalesce_transfer_steps(pkg.codegen.build_plan(
            pkg.core.dsh(c.dag, m - 1), c.dag)) for pkg, c in ((REF, ref), (PORT, port))]
        assert codegen.plan_fingerprint(news[1]) == jax_plan.plan_fingerprint(news[0])
        for k in steps:
            w = int(rng.integers(m))
            killed = _run_both(ref, port, faults=[("kill", k, w)])
            assert killed.status == "killed" and killed.step == k
            resumed = []
            for pkg, c, new_plan in ((REF, ref, news[0]), (PORT, port, news[1])):
                layout = pkg.faults._plan_layout(c.plan, c.sliced)
                new_layout = pkg.faults._plan_layout(new_plan, c.sliced)
                snap = (killed if pkg is PORT else pkg.faults.run_with_faults(
                    c.plan, c.sliced, c.params, c.x, layout,
                    faults=pkg.faults.FaultPlan.single_kill(k, w))).snapshot
                bufs, completed, stats = pkg.codegen.migrate_registers(
                    c.plan, new_plan, layout, new_layout, snap, k)
                assert stats["resumed_from_step"] == k
                res = pkg.faults.resume_plan(new_plan, c.sliced, c.params, c.x, new_layout,
                                             bufs, completed)
                resumed.append((bufs, completed, stats, res))
            (jb, jc, js, jr), (tb, tc, ts, tr) = resumed
            assert tc == jc and ts == js
            for got, want in zip(tb, jb):
                np.testing.assert_allclose(got, want, **TOL)
            assert_same_outcome(tr, jr)
            assert tr.status == "ok", (case, k, w)
            np.testing.assert_allclose(tr.output, seq, **SEQ_TOL, err_msg=f"{case} kill@{k}/w{w}")

    def test_migration_stats_monotone_as_reference(self):
        ref, port, _ = _sliced("lenet5", "channel", 4)
        new_plan = codegen.coalesce_transfer_steps(
            codegen.build_plan(core.dsh(port.dag, 3), port.dag))
        jnew = jax_codegen.coalesce_transfer_steps(
            jax_codegen.build_plan(jax_core.dsh(ref.dag, 3), ref.dag))
        layout, new_layout = (faults._plan_layout(p, port.sliced) for p in (port.plan, new_plan))
        jlayout, jnew_layout = (jax_faults._plan_layout(p, ref.sliced) for p in (ref.plan, jnew))
        done = []
        for k in range(1, len(port.plan.steps)):
            out = _run_both(ref, port, faults=[("kill", k, 0)])
            _, completed, stats = codegen.migrate_registers(
                port.plan, new_plan, layout, new_layout, out.snapshot, k)
            jout = jax_faults.run_with_faults(ref.plan, ref.sliced, ref.params, ref.x, jlayout,
                                              faults=jax_faults.FaultPlan.single_kill(k, 0))
            _, jcompleted, jstats = jax_codegen.migrate_registers(
                ref.plan, jnew, jlayout, jnew_layout, jout.snapshot, k)
            assert (completed, stats) == (jcompleted, jstats)
            assert stats["completed_nodes"] == len(completed)
            done.append(stats["completed_nodes"])
        assert done == sorted(done) and done[-1] > done[0]


# --------------------------------------------------------------------------- #
# the drill: kill, detect, replan (deep-validated), migrate, resume
# --------------------------------------------------------------------------- #
DRILL_KEYS = ("kill_step", "kill_worker", "detected", "migrated_bytes", "placements",
              "completed_nodes", "recomputed_supersteps", "recomputed_nodes", "n_steps_old",
              "n_steps_new")


def _drills(ref, port, hw=False, **kw):
    """The drill in both packages (priced with ``KEYSTONE_CPU`` if ``hw``),
    held equal; returns the port's."""
    jd, td = (pkg.faults.kill_and_resume_drill(
        c.sliced, c.params, c.x, c.dag, hw=pkg.costmodel.KEYSTONE_CPU if hw else None, **kw)
        for pkg, c in ((REF, ref), (PORT, port)))
    assert {k: td[k] for k in DRILL_KEYS} == {k: jd[k] for k in DRILL_KEYS}
    for k in ("old_plan", "new_plan"):
        assert codegen.plan_fingerprint(td[k]) == jax_plan.plan_fingerprint(jd[k])
    assert (td["certificate"] is None) == (jd["certificate"] is None)
    if jd["certificate"] is not None:
        assert dataclasses.astuple(td["certificate"]) == dataclasses.astuple(jd["certificate"])
    assert isinstance(td["output"], np.ndarray)
    np.testing.assert_allclose(td["output"], np.asarray(jd["output"]), **TOL)
    assert td["replan_ms"] > 0
    return td


class TestKillAndResumeDrill:
    def test_headline_inception_grid(self):
        ref, port, seq = _sliced("inception", "grid8", 8)
        drill = _drills(ref, port, m=8, kill_step=4, kill_worker=3, hw=True)
        np.testing.assert_allclose(drill["output"], seq, **SEQ_TOL)
        assert drill["detected"] and drill["new_plan"].n_workers == 7
        assert drill["recomputed_supersteps"] <= 1
        assert drill["migrated_bytes"] > 0 and drill["placements"] > 0
        cert = drill["certificate"]
        assert cert.n_steps == len(drill["new_plan"].steps)
        assert cert.total >= drill["new_plan"].makespan

    def test_seeded_kill_is_deterministic(self):
        ref, port, seq = _sliced("lenet5", "channel", 4)
        a = _drills(ref, port, m=4, seed=3)
        b = faults.kill_and_resume_drill(port.sliced, port.params, port.x, port.dag, m=4, seed=3)
        assert (a["kill_step"], a["kill_worker"]) == (b["kill_step"], b["kill_worker"])
        np.testing.assert_array_equal(a["output"], b["output"])
        np.testing.assert_allclose(a["output"], seq, **SEQ_TOL)


# --------------------------------------------------------------------------- #
# the elastic planner: the same verdicts, the same replans
# --------------------------------------------------------------------------- #
def _dead_worker_detected(pkg):
    mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=10.0)
    for w in range(4):
        mon.heartbeat(w)
    mon.advance(5.0)
    for w in (0, 1, 2):
        mon.heartbeat(w)
    mon.advance(6.0)
    for w in (0, 1, 2):
        mon.heartbeat(w)
    v = mon.check()
    assert v["dead"] == [3] and mon.alive_workers() == [0, 1, 2]
    return v, _monitor_state(mon)


def _straggler_detected(pkg):
    mon = pkg.elastic.HealthMonitor(4, straggler_factor=2.0)
    for step in range(8):
        for w in range(4):
            mon.record_step(step, 1.0 if w != 2 else 5.0, worker=w)
    v = mon.check()
    assert v["stragglers"] == [2]
    return v, _monitor_state(mon)


def _remesh_resolves_schedule(pkg):
    dag = pkg.core.random_dag(20, 0.15, seed=2)
    mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=1.0)
    for w in range(4):
        mon.heartbeat(w)
    mon.advance(2.0)
    for w in (0, 1, 2):
        mon.heartbeat(w)
    plan = pkg.elastic.ElasticPlanner(dag, heuristic="dsh").replan(mon)
    assert plan.action == "remesh" and plan.workers == (0, 1, 2)
    assert plan.schedule.n_workers == 3
    pkg.core.validate(plan.schedule, dag)
    return plan.action, plan.workers, plan.makespan, _instances(plan.schedule)


def _all_dead_raises(pkg):
    mon = pkg.elastic.HealthMonitor(1, heartbeat_timeout=0.5)
    mon.advance(10.0)
    with pytest.raises(RuntimeError) as ei:
        pkg.elastic.ElasticPlanner(pkg.core.random_dag(5, 0.3)).replan(mon)
    return str(ei.value)


def _dead_worker_excluded_from_fleet_median(pkg):
    mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=10.0, straggler_factor=2.0)
    for step in range(6):
        for w in (0, 1):
            mon.record_step(step, 1.0, worker=w)
        mon.record_step(step, 2.5, worker=2)
        mon.record_step(step, 25.0, worker=3)
    mon.advance(20.0)
    for step in range(6, 8):
        for w in (0, 1):
            mon.record_step(step, 1.0, worker=w)
        mon.record_step(step, 2.5, worker=2)
    v = mon.check()
    assert v["dead"] == [3] and v["stragglers"] == [2]
    assert mon.check() == v  # stable under repetition
    return v, _monitor_state(mon)


def _straggler_detected_at_zero_median(pkg):
    mon = pkg.elastic.HealthMonitor(4, straggler_factor=2.0)
    for step in range(6):
        for w in (0, 1, 2):
            mon.record_step(step, 0.0, worker=w)
        mon.record_step(step, 1.0, worker=3)
    v = mon.check(commit=False)
    assert v["stragglers"] == [3] and not mon.workers[3].straggler
    return v, mon.check(), _monitor_state(mon)


def _record_step_attributes_step(pkg):
    mon = pkg.elastic.HealthMonitor(2, window=4)
    for s, dt in [(0, 1.0), (1, 2.0), (7, 3.0)]:
        mon.record_step(s, dt, worker=1)
    assert mon.workers[1].timings == [(0, 1.0), (1, 2.0), (7, 3.0)]
    for s in range(10, 16):
        mon.record_step(s, 1.0, worker=1)
    assert len(mon.workers[1].timings) == 4 and mon.workers[1].timings[-1] == (15, 1.0)
    return _monitor_state(mon)


def _deadline_verdict_from_certificate(pkg):
    cert = pkg.codegen.WCETCertificate(compute_bounds=(1.0, 1.0), comm_bounds=(0.0, 0.0))
    mon = pkg.elastic.HealthMonitor(2)
    mon.record_step(0, 0.5, worker=0)
    mon.record_step(1, 5.0, worker=1)
    v = mon.check(certificate=cert)
    assert v["deadline"] == [1] and v["dead"] == []
    assert mon.check(certificate=cert, slack=10.0)["deadline"] == []
    assert "deadline" not in mon.check()
    return v


def _deadline_overrun_triggers_replan(pkg):
    cert = pkg.codegen.WCETCertificate(compute_bounds=(1.0,), comm_bounds=(0.0,))
    dag = pkg.core.random_dag(20, 0.15, seed=5)
    mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=100.0)
    for w in range(4):
        mon.record_step(0, 4.0 if w == 2 else 3.0, worker=w)
    plan = pkg.elastic.ElasticPlanner(dag).replan(mon, certificate=cert)
    assert plan.action == "deadline_replan" and plan.schedule.n_workers == 4
    pkg.core.validate(plan.schedule, dag)
    return plan.action, plan.workers, plan.makespan, _instances(plan.schedule)


def _sliced_replan_ships_plan_and_certificate(pkg):
    model = pkg.cnn.lenet5()
    sliced = pkg.slicing.slice_model(model, pkg.slicing.uniform_factors(model, 4))
    sdag = sliced.to_dag(pkg.costmodel.KEYSTONE_CPU, time_unit=1e-6)
    mon = pkg.elastic.HealthMonitor(4, heartbeat_timeout=1.0)
    for w in range(4):
        mon.heartbeat(w)
    mon.advance(2.0)
    for w in (0, 1, 2):
        mon.heartbeat(w)
    plan = pkg.elastic.ElasticPlanner(sdag, model=sliced, hw=pkg.costmodel.KEYSTONE_CPU).replan(mon)
    assert plan.action == "remesh" and plan.workers == (0, 1, 2)
    assert plan.plan is not None and plan.plan.n_workers == 3
    return (plan.workers, pkg.plan.plan_fingerprint(plan.plan),
            dataclasses.astuple(plan.certificate))


def _instances(schedule):
    return [(i.node, i.worker, i.start) for i in schedule.instances]


SCENARIOS = [_dead_worker_detected, _straggler_detected, _remesh_resolves_schedule,
             _all_dead_raises, _dead_worker_excluded_from_fleet_median,
             _straggler_detected_at_zero_median, _record_step_attributes_step,
             _deadline_verdict_from_certificate, _deadline_overrun_triggers_replan,
             _sliced_replan_ships_plan_and_certificate]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__.strip("_"))
def test_elastic_scenario_as_reference(scenario):
    assert scenario(PORT) == scenario(REF)


@pytest.mark.parametrize("event", ["kill", "straggle"])
@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("builder", ["lenet5", "inception"])
def test_replans_equal(builder, m, event):
    """m -> m - 1 on the grid-sliced lenet5(28) and inception(32): a worker
    killed (its heartbeat goes stale) or a straggler excluded; the replan,
    deep-validated in both packages, equal by fingerprint and certificate."""
    got = []
    for pkg, model in ((REF, jax_model(builder, "grid")), (PORT, torch_model(builder, "grid"))):
        dag = model.to_dag(pkg.costmodel.KEYSTONE_CPU, time_unit=1e-6)
        mon = pkg.elastic.HealthMonitor(m, heartbeat_timeout=1.0)
        for step in range(4):
            for w in range(m):
                mon.record_step(step, 6.0 if (event == "straggle" and w == 1) else 1.0, worker=w)
        if event == "kill":
            mon.advance(2.0)
            for w in range(m - 1):
                mon.heartbeat(w)
        planner = pkg.elastic.ElasticPlanner(dag, model=model, hw=pkg.costmodel.KEYSTONE_CPU)
        ep = planner.replan(mon, exclude_stragglers=event == "straggle")
        got.append((ep.action, ep.workers, ep.makespan, _instances(ep.schedule),
                    pkg.plan.plan_fingerprint(ep.plan), dataclasses.astuple(ep.certificate),
                    _monitor_state(mon)))
    assert got[1] == got[0]
    action, workers = got[1][:2]
    assert len(workers) == m - 1
    assert action == ("remesh" if event == "kill" else "exclude_straggler")


# --------------------------------------------------------------------------- #
# the port's copies of validate_plan and wcet_certificate on the fault tests
# --------------------------------------------------------------------------- #
def _first_transfer(plan):
    return next((i, t) for i, s in enumerate(plan.steps) for t in s.transfers)


def _with_step(plan, i, step):
    return dataclasses.replace(plan, steps=plan.steps[:i] + (step,) + plan.steps[i + 1:])


def _transfer_before_compute(plan, sliced):
    i, t = _first_transfer(plan)
    early = dataclasses.replace(plan.steps[0], transfers=(type(t)(t.node, t.src, t.dst, t.box),))
    return dataclasses.replace(plan, steps=(early,) + plan.steps[1:]), False


def _out_of_range_endpoint(plan, sliced):
    i, t = _first_transfer(plan)
    return _with_step(plan, i, dataclasses.replace(
        plan.steps[i], transfers=(dataclasses.replace(t, dst=plan.n_workers + 1),))), False


def _degenerate_box(plan, sliced):
    i, t = _first_transfer(plan)
    return _with_step(plan, i, dataclasses.replace(
        plan.steps[i], transfers=(dataclasses.replace(t, box=((5, 3),)),))), False


def _oversized_box(plan, sliced):
    i, t = _first_transfer(plan)
    extent = sliced.spec(t.node).out_shape[0]
    return _with_step(plan, i, dataclasses.replace(
        plan.steps[i], transfers=(dataclasses.replace(t, box=((0, extent + 64),)),))), True


def _missing_compute(plan, sliced):
    steps = tuple(dataclasses.replace(s, compute=tuple(
        tuple(n for n in seg if n != plan.sink) for seg in s.compute)) for s in plan.steps)
    return dataclasses.replace(plan, steps=steps), False


def _double_compute(plan, sliced):
    i, w, _seg = next((i, w, seg) for i, s in enumerate(plan.steps)
                      for w, seg in enumerate(s.compute) if seg)
    dup = tuple((s + (s[-1],)) if j == w else s for j, s in enumerate(plan.steps[i].compute))
    return _with_step(plan, i, dataclasses.replace(plan.steps[i], compute=dup)), False


BREAKERS = [_transfer_before_compute, _out_of_range_endpoint, _degenerate_box, _oversized_box,
            _missing_compute, _double_compute]


class TestValidatePlan:
    def test_valid_plan_passes_with_reference_stats(self):
        ref, port, _ = _sliced("lenet5", "channel", 4)
        stats = codegen.validate_plan(port.plan, port.dag, model=port.sliced, cache=False)
        assert stats == jax_codegen.validate_plan(ref.plan, ref.dag, model=ref.sliced,
                                                  cache=False)
        assert stats["supersteps"] == len(port.plan.steps) and stats["transfers"] > 0
        assert stats["packed_elements"] > 0

    @pytest.mark.parametrize("breaker", BREAKERS, ids=lambda f: f.__name__.strip("_"))
    def test_broken_plan_rejected_as_reference(self, breaker):
        ref, port, _ = _sliced("lenet5", "channel", 4)
        msgs = []
        for pkg, c in ((REF, ref), (PORT, port)):
            bad, with_model = breaker(c.plan, c.sliced)
            with pytest.raises(pkg.codegen.PlanValidationError) as ei:
                pkg.codegen.validate_plan(bad, c.dag, model=c.sliced if with_model else None,
                                          cache=False)
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0]


class TestWCETCertificate:
    def _certs(self, margin=1.0, hw=None):
        ref, port, _ = _sliced("lenet5", "channel", 4)
        out = []
        for pkg, c in ((REF, ref), (PORT, port)):
            out_bytes = {l.name: float(np.prod(l.out_shape)) * 4 for l in c.sliced.layers}
            out.append(pkg.codegen.wcet_certificate(
                c.plan, c.dag, out_bytes, hw=(hw or pkg.costmodel.KEYSTONE_CPU), margin=margin))
        assert dataclasses.astuple(out[1]) == dataclasses.astuple(out[0])
        return port.plan, out[1]

    def test_certificate_covers_makespan(self):
        plan, cert = self._certs()
        assert cert.n_steps == len(plan.steps) and all(b >= 0 for b in cert.step_bounds)
        assert plan.makespan <= cert.total <= 10 * plan.makespan

    def test_margin_scales_bounds(self):
        _, base = self._certs()
        _, derated = self._certs(margin=2.0)
        assert derated.total == pytest.approx(2 * base.total, rel=1e-9)

    def test_requires_pricing(self):
        _, port, _ = _sliced("lenet5", "channel", 4)
        with pytest.raises(ValueError, match="hw|comm_time"):
            codegen.wcet_certificate(port.plan, port.dag, {})

    def test_overruns_attribution_and_slack(self):
        cert = codegen.WCETCertificate(compute_bounds=(1.0, 2.0), comm_bounds=(0.5, 0.5))
        assert cert.bound(0) == 1.5 and cert.bound(1) == 2.5
        timings = [(0, 2.0), (1, 2.0), (5, 99.0), (-1, 99.0)]
        assert cert.overruns(timings) == [(0, 2.0)]
        assert cert.overruns(timings, slack=2.0) == []

    def test_hardware_derate(self):
        hw = costmodel.KEYSTONE_CPU.derate(2.0)
        assert dataclasses.astuple(hw) == dataclasses.astuple(
            jax_costmodel.KEYSTONE_CPU.derate(2.0))
        with pytest.raises(ValueError):
            costmodel.KEYSTONE_CPU.derate(0.0)
        _, port, _ = _sliced("lenet5", "channel", 4)
        out_bytes = {n: 4096.0 for n in port.dag.nodes}
        slow = codegen.wcet_certificate(port.plan, port.dag, out_bytes, hw=hw)
        fast = codegen.wcet_certificate(port.plan, port.dag, out_bytes, hw=costmodel.KEYSTONE_CPU)
        assert slow.total > fast.total
