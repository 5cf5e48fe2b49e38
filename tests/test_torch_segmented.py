"""The port's segmented executor (``build_mpmd_executor(segmented=True)``)
on the CPU against the JAX package, on the plans of ``_torch_cnn_cases``:

* outputs against the reference's ``interpret_plan`` at ``rtol = atol =
  1e-5`` (the same op semantics as ``test_torch_cnn.py``, in another order),
  at buffer depths 1, 2 and 4, with and without checkpoints;
* outputs and checkpoint snapshots bit-identical across the reference's knob
  matrix (``span_coalesce`` x ``cohort_rounds`` x ``bake_params`` x
  ``liveness`` x depth, as in ``test_scan_executor.py``'s
  ``TestKnobBitIdentity`` and ``TestStreamBitIdentity``);
* snapshots equal to the port's fault-runner barriers and resumable from
  every segment boundary (``test_faults.py``'s ``TestCheckpointExecutor``
  and ``TestCheckpointKnobInvariance``);
* ``.width``, ``.layout``, ``.segment_spans``, ``.checkpoint_steps`` and
  ``.segment_stats`` equal to the reference executor's, and its outputs and
  snapshots allclose to the port's (one subprocess with 8 host devices),
  and ``executed_comm_bytes(segmented=True)`` equal to the reference's;
* the reference's argument errors, and a carry that persists across calls
  without leaking one input into the next.
"""
import functools
import itertools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codegen as jax_codegen
import repro.core as jax_core
import repro.core.costmodel as jax_costmodel
import repro_torch.codegen as codegen
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
from _torch_cnn_cases import (  # one_intra_op_thread: an autouse fixture
    BATCH, CASE_IDS, CASES, jax_model, numpy_input, numpy_params, one_intra_op_thread,
    torch_model,
)
from repro_torch.codegen.plan import RegisterLayout
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.runtime.faults import _plan_layout, resume_plan, run_with_faults

TOL = dict(rtol=1e-5, atol=1e-5)
DEPTHS = (1, 2, 4)
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@functools.lru_cache(maxsize=None)
def _case(builder, sl, sched, m):
    """(reference plan, port plan, reference model, port model, port
    params, two inputs, the reference interpreter's outputs on them)."""
    jm, tm = jax_model(builder, sl), torch_model(builder, sl)
    jdag = jm.to_dag(jax_costmodel.KEYSTONE_CPU, time_unit=1e-6)
    tdag = tm.to_dag(costmodel.KEYSTONE_CPU, time_unit=1e-6)
    jplan = jax_codegen.build_plan(getattr(jax_core, sched)(jdag, m), jdag)
    tplan = codegen.build_plan(getattr(core, sched)(tdag, m), tdag)
    pnp = numpy_params(builder)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
    tp = cnn_params_from_numpy(pnp, device="cpu")
    xs = (numpy_input(builder), numpy_input(builder, seed=2))
    refs = tuple(np.asarray(jax_codegen.interpret_plan(jplan, jm, jp, jnp.asarray(x)))
                 for x in xs)
    return jplan, tplan, jm, tm, tp, xs, refs


def _build(case, **kw):
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*case)
    return codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH,
                                       segmented=True, **kw)


def _x(case, k: int = 0) -> torch.Tensor:
    return torch.from_numpy(_case(*case)[5][k])


@functools.lru_cache(maxsize=None)
def _depth1(case):
    """The default executor's output and snapshot register region."""
    f = _build(case, checkpoint=True)
    y, snaps = f(_x(case))
    return y.numpy(), snaps[:, :, :, :f.layout.total].numpy().copy()


# --------------------------------------------------------------------------- #
# outputs against the reference interpreter
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_outputs_match_reference_interpreter(case, depth, checkpoint):
    jplan, _tplan, jm, _tm, _tp, _xs, refs = _case(*case)
    f = _build(case, checkpoint=checkpoint, buffer_depth=depth)
    out = f(_x(case))
    if checkpoint:
        out, snaps = out
        assert tuple(snaps.shape) == (len(f.segment_spans), case[3], BATCH, f.width)
        assert f.width >= f.layout.total + 3  # registers, sentinels, dump column
    assert out.dtype == torch.float32 and tuple(out.shape) == refs[0].shape
    np.testing.assert_allclose(out.numpy(), refs[0], **TOL)
    again = f.eager(_x(case))
    np.testing.assert_array_equal((again[0] if checkpoint else again).numpy(), out.numpy())
    assert f.comm_real_bytes == jax_codegen.executed_comm_bytes(
        jplan, jm, batch=BATCH, segmented=True, buffer_depth=depth)
    shipped = sum(s["comm_shipped_elems"] for s in f.segment_stats)
    assert f.comm_bytes == shipped * BATCH * 4
    assert f.streams == [] and f.streams_used == set()


# --------------------------------------------------------------------------- #
# knobs and depths are bit-identical ablations
# --------------------------------------------------------------------------- #
KNOB_CASES = [CASES[2], CASES[6]]  # the two m = 8 plans: grid tiles, glue
KNOBS = list(itertools.product((True, False), repeat=4))  # span, cohort, bake, liveness


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "sc%d-cr%d-bp%d-live%d" % k)
@pytest.mark.parametrize("case", KNOB_CASES, ids=[CASE_IDS[2], CASE_IDS[6]])
def test_knob_matrix_bit_identical(case, knobs, depth):
    """span_coalesce / cohort_rounds / bake_params / liveness / buffer_depth
    rearrange the issue, never the arithmetic: outputs equal the default
    executor's bit for bit, and so do the snapshots' register regions
    wherever the packing is the same (liveness on)."""
    sc, cr, bp, live = knobs
    f = _build(case, checkpoint=True, span_coalesce=sc, cohort_rounds=cr, bake_params=bp,
               liveness=live, buffer_depth=depth)
    y, snaps = f(_x(case))
    ref_y, ref_snaps = _depth1(case)
    np.testing.assert_array_equal(y.numpy(), ref_y)
    if live:
        np.testing.assert_array_equal(snaps[:, :, :, :f.layout.total].numpy(), ref_snaps)


@pytest.mark.parametrize("depth", (2, 4))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_stream_depths_bit_identical(case, depth):
    """Rotating staging frames, retire copies and the persistent carry
    change no output or snapshot bit; the staging footprint is counted
    once, globally."""
    f = _build(case, checkpoint=True, buffer_depth=depth)
    y, snaps = f(_x(case))
    ref_y, ref_snaps = _depth1(case)
    np.testing.assert_array_equal(y.numpy(), ref_y)
    np.testing.assert_array_equal(snaps[:, :, :, :f.layout.total].numpy(), ref_snaps)
    assert len({s["peak_staging_elems"] for s in f.segment_stats}) == 1
    assert all(s["buffer_depth"] == depth for s in f.segment_stats)
    assert all(s["retire_elems"] == 0 for s in _build(case).segment_stats)


# --------------------------------------------------------------------------- #
# checkpoints: the fault runner's barriers, and resumes from them
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_snapshots_equal_runner_barriers(case, depth):
    """Unpacked (``liveness=False``: a column per register), every snapshot
    equals the runner's barrier entering ``checkpoint_steps[k]``, bit for
    bit.  (Packed, the slots of dead registers hold whichever dead value
    each side wrote last: the reference's executor and runner differ there
    too, on these inception plans.)"""
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*case)
    plan = codegen.coalesce_transfer_steps(tplan)
    layout = RegisterLayout.of(plan, {l.name: tuple(l.out_shape) for l in tm.layers},
                               liveness=None)
    f = _build(case, checkpoint=True, liveness=False, buffer_depth=depth)
    assert dict(f.layout.offsets) == dict(layout.offsets) and f.layout.total == layout.total
    _y, snaps = f(_x(case))
    oracle = run_with_faults(plan, tm, tp, _x(case), layout, keep_snapshots=True)
    assert f.checkpoint_steps == tuple(stop for _start, stop in f.segment_spans)
    for k, stop in enumerate(f.checkpoint_steps):
        np.testing.assert_array_equal(snaps[k, :, :, :layout.total].numpy(),
                                      np.stack(oracle.snapshots[stop]), err_msg=f"segment {k}")


# the reference's own checkpoint cases (test_faults.py, test_serve_chaos.py):
# sliced lenet5 at m = 4, packed with liveness
RUNNER_CASES = [("lenet5", "channel", "dsh", 4), ("lenet5", "rows", "dsh", 4)]


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", RUNNER_CASES, ids=["lenet5-channel", "lenet5-rows"])
def test_packed_snapshots_equal_runner_barriers(case, depth):
    _jplan, tplan, _jm, tm, tp, _xs, refs = _case(*case)
    plan = codegen.coalesce_transfer_steps(tplan)
    layout = _plan_layout(plan, tm)
    f = _build(case, checkpoint=True, buffer_depth=depth)
    assert dict(f.layout.offsets) == dict(layout.offsets) and f.layout.total == layout.total
    y, snaps = f(_x(case))
    np.testing.assert_allclose(y.numpy(), refs[0], **TOL)
    oracle = run_with_faults(plan, tm, tp, _x(case), layout, keep_snapshots=True)
    for k, stop in enumerate(f.checkpoint_steps):
        np.testing.assert_array_equal(snaps[k, :, :, :layout.total].numpy(),
                                      np.stack(oracle.snapshots[stop]), err_msg=f"segment {k}")


@pytest.mark.parametrize("case", CASES + RUNNER_CASES, ids=CASE_IDS + ["lenet5-channel", "lenet5-rows"])
def test_resume_from_every_segment_boundary(case):
    """Each boundary snapshot of the streamed (depth-4) executor restarts the
    runner on the same plan, and the run still reaches the reference's
    output: a kill at any barrier never observes a frame in flight."""
    _jplan, tplan, _jm, tm, tp, _xs, refs = _case(*case)
    plan = codegen.coalesce_transfer_steps(tplan)
    layout = _plan_layout(plan, tm)
    f = _build(case, checkpoint=True, buffer_depth=4)
    _y, snaps = f(_x(case))
    m = case[3]
    for k, (_start, stop) in enumerate(f.segment_spans[:-1]):
        bufs = [snaps[k, w, :, :layout.total].numpy() for w in range(m)]
        done = {n for s in plan.steps[:stop] for seg in s.compute for n in seg}
        res = resume_plan(plan, tm, tp, _x(case), layout, bufs, done)
        assert res.status == "ok", (k, stop)
        np.testing.assert_allclose(res.output, refs[0], **TOL, err_msg=f"resume from segment {k}")


# --------------------------------------------------------------------------- #
# tables, stats and snapshots against the reference executor
# --------------------------------------------------------------------------- #
REF_KNOBS = {
    "depth1": {},
    "depth2": {"buffer_depth": 2},
    "depth4": {"buffer_depth": 4},
    "no_span": {"span_coalesce": False},
    "no_cohort": {"cohort_rounds": False},
    "bake": {"bake_params": True},
    "no_liveness": {"liveness": False},
}

_REF_SCRIPT = r'''
import json, sys
sys.path.insert(0, TESTS_DIR)
import jax, jax.numpy as jnp, numpy as np
import repro.codegen as jc, repro.core as jcore, repro.core.costmodel as jcm
from repro.codegen.executor import build_mpmd_executor
from _torch_cnn_cases import BATCH, CASES, CASE_IDS, jax_model, numpy_input, numpy_params

tables, arrays = {}, {}
for case, cid in zip(CASES, CASE_IDS):
    b, sl, sch, m = case
    jm = jax_model(b, sl)
    dag = jm.to_dag(jcm.KEYSTONE_CPU, time_unit=1e-6)
    plan = jc.build_plan(getattr(jcore, sch)(dag, m), dag)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in numpy_params(b).items()}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:m]), ("workers",))
    for name, kw in REF_KNOBS.items():
        f = build_mpmd_executor(plan, jm, jp, mesh, batch=BATCH, segmented=True,
                                checkpoint=True, **kw)
        tables[cid + "|" + name] = dict(
            width=f.width, total=f.layout.total, offsets=dict(f.layout.offsets),
            shapes=dict(f.layout.shapes), spans=f.segment_spans,
            steps=f.checkpoint_steps, stats=f.segment_stats)
        if name.startswith("depth"):
            y, snaps = f(numpy_input(b))
            arrays[cid + "|" + name + "|y"] = np.asarray(y)
            arrays[cid + "|" + name + "|snaps"] = np.asarray(snaps)
json.dump(tables, open(OUT + ".json", "w"))
np.savez(OUT + ".npz", **arrays)
print("REF_TABLES_OK")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's segmented executors on every case and knob setting,
    built (and, at each depth, run) in one subprocess with 8 host devices."""
    from conftest import run_subprocess

    out = str(tmp_path_factory.mktemp("segmented_reference") / "ref")
    code = (_REF_SCRIPT.replace("TESTS_DIR", repr(TESTS_DIR)).replace("OUT", repr(out))
            .replace("REF_KNOBS.items()", f"{REF_KNOBS!r}.items()"))
    assert "REF_TABLES_OK" in run_subprocess(code, devices=8, timeout=600)
    with open(out + ".json") as fh:
        tables = json.load(fh)
    return tables, dict(np.load(out + ".npz"))


def _as_json(v):
    return json.loads(json.dumps(v))


@pytest.mark.parametrize("knob", list(REF_KNOBS))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_tables_and_stats_equal_reference(reference, case, knob):
    f = _build(case, checkpoint=True, **REF_KNOBS[knob])
    want = reference[0][f"{CASE_IDS[CASES.index(case)]}|{knob}"]
    got = _as_json(dict(
        width=f.width, total=f.layout.total, offsets=dict(f.layout.offsets),
        shapes=dict(f.layout.shapes), spans=f.segment_spans, steps=f.checkpoint_steps,
        stats=f.segment_stats))
    assert got == want


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_outputs_and_snapshots_allclose_reference(reference, case, depth):
    """Whole carries, staging columns included: on a first call both
    executors start from zeros and land the same payloads in the same
    strips."""
    key = f"{CASE_IDS[CASES.index(case)]}|depth{depth}"
    f = _build(case, checkpoint=True, buffer_depth=depth)
    y, snaps = f(_x(case))
    np.testing.assert_allclose(y.numpy(), reference[1][key + "|y"], **TOL)
    np.testing.assert_allclose(snaps.numpy(), reference[1][key + "|snaps"], **TOL)


@pytest.mark.parametrize("liveness", [True, False])
@pytest.mark.parametrize("cohort", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_executed_comm_bytes_equal_reference(case, depth, cohort, liveness):
    jplan, tplan, jm, tm, _tp, _xs, _refs = _case(*case)
    kw = dict(batch=BATCH, segmented=True, buffer_depth=depth, cohort_rounds=cohort,
              liveness=liveness)
    want = jax_codegen.executed_comm_bytes(jplan, jm, **kw)
    assert codegen.executed_comm_bytes(tplan, tm, **kw) == want
    out_bytes = {l.name: l.out_bytes() for l in tm.layers}
    plan = codegen.coalesce_transfer_steps(tplan)
    assert want == pytest.approx(plan.comm_bytes(out_bytes) * BATCH)


# --------------------------------------------------------------------------- #
# errors, the device, and the carry across calls
# --------------------------------------------------------------------------- #
def test_checkpoint_requires_segmented():
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*CASES[4])
    with pytest.raises(ValueError, match="segmented"):
        codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH, checkpoint=True)


@pytest.mark.parametrize("depth", [0, -1, 1.5, "2"])
def test_bad_buffer_depth_raises(depth):
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*CASES[4])
    with pytest.raises(ValueError, match="buffer_depth must be a positive int"):
        codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH, segmented=True,
                                    buffer_depth=depth)


def test_streaming_requires_segmented():
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*CASES[4])
    with pytest.raises(ValueError, match="requires segmented=True"):
        codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH, buffer_depth=2)


def test_segmented_checks_its_input():
    case = CASES[4]
    f = _build(case)
    x = _case(*case)[5][0]
    with pytest.raises(ValueError, match="batch=2"):
        f(torch.from_numpy(x[:1]))
    with pytest.raises(ValueError, match="batch=2"):
        f.eager(torch.from_numpy(np.concatenate([x, x])))
    with pytest.raises(ValueError, match="input shape"):
        f(torch.from_numpy(x[..., :-1]))


def test_segmented_default_device_is_the_card():
    _jplan, tplan, _jm, tm, tp, _xs, _refs = _case(*CASES[4])
    if torch.cuda.is_available():
        f = codegen.build_mpmd_executor(tplan, tm, tp, segmented=True)
        assert len(f.streams) == 4
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            codegen.build_mpmd_executor(tplan, tm, tp, segmented=True)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", [CASES[2], CASES[3]], ids=[CASE_IDS[2], CASE_IDS[3]])
def test_carry_does_not_leak_across_calls(case, depth):
    """Two calls with two inputs, then the first again: each output is the
    reference's for its own input, and the snapshots of a call equal a
    fresh executor's — nothing stale survives in the persistent carry."""
    refs = _case(*case)[6]
    f = _build(case, checkpoint=True, buffer_depth=depth)
    for k in (0, 1, 0):
        y, snaps = f(_x(case, k))
        np.testing.assert_allclose(y.numpy(), refs[k], **TOL)
    fresh_y, fresh_snaps = _build(case, checkpoint=True, buffer_depth=depth)(_x(case, 0))
    np.testing.assert_array_equal(y.numpy(), fresh_y.numpy())
    total = f.layout.total
    np.testing.assert_array_equal(snaps[:, :, :, :total].numpy(),
                                  fresh_snaps[:, :, :, :total].numpy())


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("case", [CASES[2], CASES[6]], ids=[CASE_IDS[2], CASE_IDS[6]])
def test_each_call_reinitializes_what_it_reads(case, depth):
    """Between two calls every carry column is poisoned with NaN: each call
    rewrites the registers, the zero and -inf sentinels (depth >= 2 keeps
    only the staging columns, which are written before they are read), so
    the second call's output is the first's bit for bit."""
    f = _build(case, buffer_depth=depth)
    first = f(_x(case)).numpy()
    for buf in f._bufs:
        buf.fill_(float("nan"))
    np.testing.assert_array_equal(f(_x(case)).numpy(), first)
