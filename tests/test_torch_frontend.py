"""The port's serving frontend (``repro_torch.serve.frontend``, ``trace``)
against the reference's, on every scenario of ``tests/test_serve_chaos.py``.

Both packages get the same sliced lenet5 (m = 4), the same weights (numpy,
seeded, ``convert.cnn_params_from_numpy``) and the same traces and chaos
campaigns.  The clock is simulated, so statuses, shed reasons, retries,
latencies, recoveries and audits must be equal exactly; ``fingerprint()``
is compared without its last field (``hash`` of the output bytes: Python
salts it per process, and two libraries differ in the last bits) and the
outputs to ``rtol = atol = 1e-5``.  The executor fast path
(``attach_executor``) runs on the CPU here (``device="cpu"``), against the
reference's on 4 host devices in a subprocess."""
import dataclasses
import functools
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.costmodel as jax_costmodel
import repro.models.cnn as jax_cnn
import repro.models.slicing as jax_slicing
import repro.serve as jax_serve
import repro_torch.codegen as codegen
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
import repro_torch.models.cnn as cnn
import repro_torch.models.slicing as slicing
import repro_torch.serve as serve
from _torch_cnn_cases import BATCH, numpy_params, one_intra_op_thread  # noqa: F401 (autouse)
from repro.serve.frontend import FaultEvent as JaxFaultEvent
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.runtime.faults import _plan_layout, run_with_faults
from repro_torch.serve.frontend import FaultEvent

TOL = dict(rtol=1e-5, atol=1e-5)
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def package(name: str) -> SimpleNamespace:
    """One package's sliced lenet5 (m = 4), weights, input pool and
    per-pool-entry sequential references."""
    if name == "ref":
        mods = SimpleNamespace(serve=jax_serve, cnn=jax_cnn, slicing=jax_slicing,
                               hw=jax_costmodel.KEYSTONE_CPU, FaultEvent=JaxFaultEvent)
    else:
        mods = SimpleNamespace(serve=serve, cnn=cnn, slicing=slicing,
                               hw=costmodel.KEYSTONE_CPU, FaultEvent=FaultEvent)
    model = mods.cnn.lenet5()
    sliced = mods.slicing.slice_model(model, mods.slicing.uniform_factors(model, 4))
    dag = sliced.to_dag(mods.hw, time_unit=1e-6)
    pnp = numpy_params("lenet5")
    pool = mods.serve.input_pool(model.layers[0].out_shape, 8, seed=3)
    if name == "ref":
        params = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
        refs = np.stack([np.asarray(jax_cnn.run_sequential(sliced, params, pool[k:k + 1]))[0]
                         for k in range(8)])
    else:
        params = cnn_params_from_numpy(pnp, device="cpu")
        refs = np.stack([cnn.run_sequential(sliced, params, torch.from_numpy(pool[k:k + 1]))[0]
                         .numpy() for k in range(8)])
    return SimpleNamespace(**vars(mods), sliced=sliced, dag=dag, params=params, pool=pool,
                           refs=refs)


def make_frontend(P, **cfg_kw):
    cfg = P.serve.FrontendConfig(**cfg_kw) if cfg_kw else P.serve.FrontendConfig()
    return P.serve.Frontend(P.sliced, P.params, P.dag, m=4, hw=P.hw, cfg=cfg)


def _without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def assert_same_outcome(a, b, refs_a=None, refs_b=None):
    """Frontends ``a`` (reference) and ``b`` (port) served identically."""
    assert [e[:5] for e in a.fingerprint()] == [e[:5] for e in b.fingerprint()]
    assert [_without(r, "replan_ms") for r in a.recoveries] == \
        [_without(r, "replan_ms") for r in b.recoveries]
    assert (a.fleet, a.cordoned, a.degraded, a.completed, a.retried, a.deadline_misses,
            a.runs, a.exec_runs) == (b.fleet, b.cordoned, b.degraded, b.completed, b.retried,
                                     b.deadline_misses, b.runs, b.exec_runs)
    assert _without(a.audit(ref_pool=refs_a), "max_err") == \
        _without(b.audit(ref_pool=refs_b), "max_err")
    assert sorted(a.ledger) == sorted(b.ledger)
    for rid, ra in a.ledger.items():
        rb = b.ledger[rid]
        if ra.output is None:
            assert rb.output is None
        else:
            np.testing.assert_allclose(rb.output, np.asarray(ra.output), **TOL,
                                       err_msg=f"request {rid}")


def on_both(scenario):
    """Run ``scenario(P)`` on the reference, then on the port; return both
    results."""
    return scenario(package("ref")), scenario(package("port"))


# --------------------------------------------------------------------------- #
# TestTrace
# --------------------------------------------------------------------------- #
def test_same_seed_same_trace():
    for P in (package("ref"), package("port")):
        a = P.serve.poisson_trace(50, seed=9, rate=0.5)
        assert a == P.serve.poisson_trace(50, seed=9, rate=0.5)
        assert a != P.serve.poisson_trace(50, seed=10, rate=0.5)
    a, b = on_both(lambda P: P.serve.poisson_trace(50, seed=9, rate=0.5))
    assert [dataclasses.astuple(r) for r in a] == [dataclasses.astuple(r) for r in b]


def test_trace_shape():
    def scenario(P):
        tr = P.serve.poisson_trace(30, seed=1, rate=2.0, rows=(1, 2), pool_size=4,
                                   deadline=(5.0, 10.0), service=3.0)
        assert len(tr) == 30
        arrivals = [r.arrival for r in tr]
        assert arrivals == sorted(arrivals) and arrivals[0] > 0
        assert all(r.rows in (1, 2) for r in tr)
        assert all(0 <= r.pool_idx < 4 for r in tr)
        assert all(15.0 <= r.deadline - r.arrival <= 30.0 for r in tr)
        return [dataclasses.astuple(r) for r in tr]

    a, b = on_both(scenario)
    assert a == b


def test_percentile_nearest_rank():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert serve.percentile(xs, 50) == 3.0
    assert serve.percentile(xs, 99) == 5.0
    assert serve.percentile([7.0], 50) == 7.0
    for q in (0, 1, 37, 50, 90, 99, 100):
        assert serve.percentile(xs, q) == jax_serve.percentile(xs, q)


def test_input_pool_equal():
    np.testing.assert_array_equal(serve.input_pool((4, 5, 3), 8, seed=3),
                                  jax_serve.input_pool((4, 5, 3), 8, seed=3))


# --------------------------------------------------------------------------- #
# TestAdmission
# --------------------------------------------------------------------------- #
def test_fault_free_drain_zero_loss():
    def scenario(P):
        fe = make_frontend(P)
        trace = P.serve.poisson_trace(40, seed=5, rate=2.0 / fe.est_service,
                                      service=fe.est_service)
        summary = fe.run_trace(trace, P.pool)
        assert summary["completed"] == 40 and summary["shed"] == 0
        audit = fe.audit(ref_pool=P.refs)
        assert audit["zero_loss"], audit
        assert audit["max_err"] < 1e-4
        return fe, _without(summary, "wall_s")

    (a, sa), (b, sb) = on_both(scenario)
    assert sa == sb
    assert_same_outcome(a, b, package("ref").refs, package("port").refs)


def test_backpressure_backoff_then_shed():
    def scenario(P):
        fe = make_frontend(P, queue_limit=2, max_retries=2)
        far = 1e9  # deadlines never bind in this test
        reqs = [P.serve.TraceRequest(i, 0.0, 1, 0, far) for i in range(6)]
        assert not isinstance(fe.submit(reqs[0], P.pool), P.serve.Backpressure)
        assert not isinstance(fe.submit(reqs[1], P.pool), P.serve.Backpressure)
        b0 = fe.submit(reqs[2], P.pool)
        assert isinstance(b0, P.serve.Backpressure) and b0.reason == "queue_full"
        b1 = fe.submit(reqs[2], P.pool)
        assert isinstance(b1, P.serve.Backpressure)
        assert b1.retry_after == pytest.approx(2.0 * b0.retry_after)
        r2 = fe.submit(reqs[2], P.pool)
        assert r2.status == "shed" and r2.shed_reason == "backpressure"
        assert fe.ledger[2].retries == 2
        return fe, (b0.retry_after, b1.retry_after)

    (a, ra), (b, rb) = on_both(scenario)
    assert ra == rb
    assert_same_outcome(a, b)


def test_deadline_shed_at_submit_and_in_queue():
    def scenario(P):
        fe = make_frontend(P)
        est = fe._est()
        r = fe.submit(P.serve.TraceRequest(0, 0.0, 1, 0, 0.5 * est), P.pool)
        assert r.status == "shed" and r.shed_reason == "deadline"
        r1 = fe.submit(P.serve.TraceRequest(1, 0.0, 1, 1, 2.0 * est), P.pool)
        assert r1.status == "queued"
        fe.monitor.advance(3.0 * est)
        fe._shed_expired()
        assert r1.status == "shed" and r1.shed_reason == "deadline"
        assert fe.audit()["zero_loss"]
        return fe, est

    (a, ea), (b, eb) = on_both(scenario)
    assert ea == eb
    assert_same_outcome(a, b)


def test_oversized_request_shed():
    def scenario(P):
        fe = make_frontend(P, max_rows=2)
        r = fe.submit(P.serve.TraceRequest(0, 0.0, 3, 0, 1e9), P.pool)
        assert r.status == "shed" and r.shed_reason == "too_large"
        return fe

    assert_same_outcome(*on_both(scenario))


def test_degraded_drains_edf():
    def scenario(P):
        fe = make_frontend(P)
        far = 1e9
        fe.submit(P.serve.TraceRequest(0, 0.0, 1, 0, far), P.pool)
        fe.submit(P.serve.TraceRequest(1, 0.0, 1, 1, far - 5e8), P.pool)  # earliest
        fe.submit(P.serve.TraceRequest(2, 0.0, 1, 2, far), P.pool)
        fe.degraded = True
        first = [r.rid for r in fe._admit()]
        assert first == [1]  # EDF, one per tick
        fe.degraded = False
        rest = sorted(r.rid for r in fe._admit())
        assert rest == [0, 2]  # full admission
        return fe, (first, rest)

    (a, oa), (b, ob) = on_both(scenario)
    assert oa == ob
    assert_same_outcome(a, b)


# --------------------------------------------------------------------------- #
# TestChaos
# --------------------------------------------------------------------------- #
def test_kill_recovery_zero_loss():
    def scenario(P):
        fe = make_frontend(P)
        trace = P.serve.poisson_trace(30, seed=8, rate=2.0 / fe.est_service,
                                      service=fe.est_service)
        chaos = P.serve.ChaosCampaign(
            events=(P.serve.ChaosEvent(10, P.FaultEvent("kill", 2, 3)),))
        summary = fe.run_trace(trace, P.pool, chaos=chaos)
        assert summary["completed"] + summary["shed"] == 30
        assert [r["action"] for r in fe.recoveries] == ["remesh"]
        assert 3 not in fe.fleet and fe.fleet == (0, 1, 2)
        rec = fe.recoveries[0]
        assert rec["dead_worker"] == 3 and rec["migrated_bytes"] > 0
        assert fe.audit(ref_pool=P.refs)["zero_loss"]
        return fe

    a, b = on_both(scenario)
    assert_same_outcome(a, b, package("ref").refs, package("port").refs)


def test_straggler_cordoned_and_admission_recovers():
    def scenario(P):
        fe = make_frontend(P)
        trace = P.serve.poisson_trace(40, seed=4, rate=2.0 / fe.est_service,
                                      service=fe.est_service)
        chaos = P.serve.ChaosCampaign(
            events=(P.serve.ChaosEvent(8, P.FaultEvent("straggle", 0, 2, 6.0)),))
        fe.run_trace(trace, P.pool, chaos=chaos)
        assert "exclude_straggler" in [r["action"] for r in fe.recoveries]
        assert 2 not in fe.fleet and 2 in fe.cordoned
        assert 2 in fe.monitor.alive_workers()
        assert not fe.degraded
        assert fe.audit(ref_pool=P.refs)["zero_loss"]
        return fe

    a, b = on_both(scenario)
    assert_same_outcome(a, b, package("ref").refs, package("port").refs)


def test_kill_and_straggle_replay_identical():
    def scenario(P):
        def run():
            fe = make_frontend(P)
            trace = P.serve.poisson_trace(60, seed=11, rate=2.0 / fe.est_service,
                                          service=fe.est_service)
            chaos = P.serve.ChaosCampaign.kill_and_straggle(60, 4, seed=7)
            fe.run_trace(trace, P.pool, chaos=chaos)
            return fe

        first, second = run(), run()
        assert first.fingerprint() == second.fingerprint()
        assert len(first.recoveries) == 2
        assert first.audit(ref_pool=P.refs)["zero_loss"]
        return first

    a, b = on_both(scenario)
    assert_same_outcome(a, b, package("ref").refs, package("port").refs)


def test_drop_round_billed_not_lost():
    def scenario(P):
        fe = make_frontend(P)
        trace = P.serve.poisson_trace(12, seed=6, rate=2.0 / fe.est_service,
                                      service=fe.est_service)
        chaos = P.serve.ChaosCampaign(
            events=(P.serve.ChaosEvent(3, P.FaultEvent("drop_round", 1, 1)),))
        summary = fe.run_trace(trace, P.pool, chaos=chaos)
        assert summary["completed"] == 12
        assert fe.fleet == (0, 1, 2, 3)
        assert fe.audit(ref_pool=P.refs)["zero_loss"]
        return fe

    a, b = on_both(scenario)
    assert_same_outcome(a, b, package("ref").refs, package("port").refs)


def test_campaign_is_deterministic():
    def scenario(P):
        a = P.serve.ChaosCampaign.kill_and_straggle(1000, 8, seed=3)
        assert a == P.serve.ChaosCampaign.kill_and_straggle(1000, 8, seed=3)
        kill, strag = a.events
        assert kill.fault.kind == "kill" and strag.fault.kind == "straggle"
        assert kill.fault.worker != strag.fault.worker
        assert kill.after_completed < strag.after_completed
        return [(e.after_completed, dataclasses.astuple(e.fault)) for e in a.events], a.seed

    a, b = on_both(scenario)
    assert a == b


# --------------------------------------------------------------------------- #
# TestExecutorTick, on the port's executor on the CPU
# --------------------------------------------------------------------------- #
def _fast_path_run():
    P = package("port")
    fe = make_frontend(P)
    fe.attach_executor(device="cpu")
    trace = serve.poisson_trace(30, seed=11, rate=2.0 / fe.est_service, service=fe.est_service)
    chaos = serve.ChaosCampaign.kill_and_straggle(30, 4, seed=7)
    fe.run_trace(trace, P.pool, chaos=chaos)
    return fe


def test_executor_fast_path_with_recovery():
    """Steady-state ticks run the checkpointed segmented executor; chaos
    ticks fall back to the interruptible runner; recovery and the
    zero-loss audit hold across the mix."""
    fe = _fast_path_run()
    audit = fe.audit(ref_pool=package("port").refs)
    assert audit["zero_loss"], audit
    assert fe.exec_runs > 0, "executor fast path never used"
    assert fe.exec_runs < fe.runs, "fault ticks must use the runner"
    assert "remesh" in [r["action"] for r in fe.recoveries]
    snaps, f = fe.last_snapshot
    assert isinstance(snaps, torch.Tensor) and snaps.shape[0] == len(f.checkpoint_steps)
    assert f.checkpoint_steps == tuple(stop for _, stop in f.segment_spans)


def test_executor_cache_keyed_on_knob_tuple():
    """Re-attaching with different knobs (here ``buffer_depth``) never
    reuses a stale executor: the cache is keyed on the full knob tuple and
    cleared on attach, and results stay bit-identical across depths."""
    P = package("port")
    pool = serve.input_pool(P.sliced.layers[0].out_shape, 4, seed=3)
    prints, keys = {}, {}
    for depth in (1, 2):
        fe = make_frontend(P)
        fe.attach_executor(device="cpu", buffer_depth=depth)
        assert fe._exec_knobs == (depth, True, True, False)
        assert not fe._exec_cache, "attach must clear the cache"
        trace = serve.poisson_trace(4, seed=5, rate=2.0 / fe.est_service, service=fe.est_service)
        fe.run_trace(trace, pool)
        assert fe.exec_runs > 0 and fe.exec_runs == fe.runs
        keys[depth] = set(fe._exec_cache)
        prints[depth] = fe.fingerprint()
    assert keys[1] != keys[2]
    assert all(k[1] == d for d in keys for k in keys[d]), keys
    assert prints[1] == prints[2]


def test_checkpoint_steps_matches_runner_barriers():
    """``checkpoint_steps[k]`` names the superstep snapshot ``k`` is the
    entering barrier of: it equals the runner's barrier there."""
    P = package("port")
    plan = codegen.build_plan(core.dsh(P.dag, 4), P.dag)
    f = codegen.build_mpmd_executor(plan, P.sliced, P.params, device="cpu", batch=BATCH,
                                    segmented=True, checkpoint=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, *P.sliced.layers[0].out_shape)).astype(np.float32))
    _y, snaps = f(x)
    layout = _plan_layout(codegen.coalesce_transfer_steps(plan), P.sliced)
    oracle = run_with_faults(codegen.coalesce_transfer_steps(plan), P.sliced, P.params, x,
                             layout, keep_snapshots=True)
    assert len(f.checkpoint_steps) == snaps.shape[0]
    assert f.checkpoint_steps == tuple(stop for _, stop in f.segment_spans)
    for k, stop in enumerate(f.checkpoint_steps):
        np.testing.assert_allclose(snaps[k, :, :, :layout.total].numpy(),
                                   np.stack(oracle.snapshots[stop]), atol=1e-5)


_REF_FAST_PATH = r'''
import json, sys
sys.path.insert(0, TESTS_DIR)
import jax.numpy as jnp, numpy as np
from repro.core.costmodel import KEYSTONE_CPU
from repro.models.cnn import lenet5
from repro.models.slicing import slice_model, uniform_factors
from repro.serve import Frontend, ChaosCampaign, poisson_trace, input_pool
from _torch_cnn_cases import numpy_params

model = lenet5()
sliced = slice_model(model, uniform_factors(model, 4))
dag = sliced.to_dag(KEYSTONE_CPU, time_unit=1e-6)
params = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in numpy_params("lenet5").items()}
fe = Frontend(sliced, params, dag, m=4, hw=KEYSTONE_CPU)
fe.attach_executor()
pool = input_pool(model.layers[0].out_shape, 8, seed=3)
trace = poisson_trace(30, seed=11, rate=2.0 / fe.est_service, service=fe.est_service)
chaos = ChaosCampaign.kill_and_straggle(30, 4, seed=7)
fe.run_trace(trace, pool, chaos=chaos)
recs = [{k: v for k, v in r.items() if k != "replan_ms"} for r in fe.recoveries]
json.dump(dict(fingerprint=[e[:5] for e in fe.fingerprint()], recoveries=recs,
               runs=fe.runs, exec_runs=fe.exec_runs, fleet=list(fe.fleet),
               steps=list(fe.last_snapshot[1].checkpoint_steps)), open(OUT + ".json", "w"))
np.savez(OUT + ".npz", **{str(rid): np.asarray(r.output) for rid, r in fe.ledger.items()
                          if r.output is not None})
print("REF_FAST_PATH_OK")
'''


def test_executor_fast_path_equals_reference(tmp_path):
    """The same trace and campaign through the reference's fast path (4 host
    devices) and the port's (the CPU): the same ticks take the executor,
    the same recoveries happen, every request ends the same way at the
    same simulated time, with outputs allclose."""
    from conftest import run_subprocess

    out = str(tmp_path / "ref")
    code = _REF_FAST_PATH.replace("TESTS_DIR", repr(TESTS_DIR)).replace("OUT", repr(out))
    assert "REF_FAST_PATH_OK" in run_subprocess(code, devices=4, timeout=600)
    with open(out + ".json") as fh:
        want = json.load(fh)
    outputs = np.load(out + ".npz")
    fe = _fast_path_run()
    recs = [_without(r, "replan_ms") for r in fe.recoveries]
    got = dict(fingerprint=[e[:5] for e in fe.fingerprint()], recoveries=recs, runs=fe.runs,
               exec_runs=fe.exec_runs, fleet=list(fe.fleet),
               steps=list(fe.last_snapshot[1].checkpoint_steps))
    assert json.loads(json.dumps(got)) == want
    assert sorted(outputs.files, key=int) == [str(r) for r in sorted(fe.ledger)
                                              if fe.ledger[r].output is not None]
    for rid in outputs.files:
        np.testing.assert_allclose(fe.ledger[int(rid)].output, outputs[rid], **TOL)


def test_attach_executor_needs_the_card_unless_asked_for_the_cpu():
    fe = make_frontend(package("port"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fe.attach_executor()
    with pytest.raises(ValueError, match="largest bucket 4 < max_rows 8"):
        fe.attach_executor(device="cpu", buckets=(1, 2, 4))
    assert fe._devices is None
    fe.attach_executor(device="cpu")
    assert fe._devices == torch.device("cpu") and fe._buckets == (1, 2, 4, 8)


def test_replan_clears_the_executor_cache():
    """A kill replans to 3 workers: the executors of the 4-worker plan are
    dropped, and the next fault-free tick builds one for the new plan."""
    fe = _fast_path_run()
    assert fe.plan.n_workers < 4
    assert fe._exec_cache, "no executor built after the replan"
    assert all(f.plan.n_workers == fe.plan.n_workers for f in fe._exec_cache.values())
