"""The port's plan execution on the CPU against the JAX package's plan
interpreter (the reference's oracle): ``interpret_plan`` and
``build_mpmd_executor(..., device="cpu")`` across ``liveness`` x
``fuse_transfers`` x ``coalesce``, whole and sliced plans of the four
builders, and the bytes the executor's destinations copy against the
reference's ``executed_comm_bytes``.  Tolerance: ``rtol = atol = 1e-5`` in
f32 (the same op semantics as ``test_torch_cnn.py``, only in another
order)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.codegen as jax_codegen
import repro.core as jax_core
import repro.core.costmodel as jax_costmodel
import repro.models.cnn as jax_cnn
import repro_torch.codegen as codegen
import repro_torch.core as core
import repro_torch.core.costmodel as costmodel
from _torch_cnn_cases import (  # one_intra_op_thread: an autouse fixture
    BATCH, CASE_IDS, CASES, jax_model, numpy_input, numpy_params, one_intra_op_thread,
    torch_model,
)
from repro_torch.convert import cnn_params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
IDS = CASE_IDS


@functools.lru_cache(maxsize=None)
def _case(builder, sl, sched, m):
    """(reference plan, port plan, reference model, port model, params as
    the reference's arrays and the port's tensors, input, the reference
    interpreter's output)."""
    jm, tm = jax_model(builder, sl), torch_model(builder, sl)
    jdag = jm.to_dag(jax_costmodel.KEYSTONE_CPU, time_unit=1e-6)
    tdag = tm.to_dag(costmodel.KEYSTONE_CPU, time_unit=1e-6)
    jplan = jax_codegen.build_plan(getattr(jax_core, sched)(jdag, m), jdag)
    tplan = codegen.build_plan(getattr(core, sched)(tdag, m), tdag)
    pnp = numpy_params(builder)
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
    tp = cnn_params_from_numpy(pnp, device="cpu")
    x = numpy_input(builder)
    ref = np.asarray(jax_codegen.interpret_plan(jplan, jm, jp, jnp.asarray(x)))
    return jplan, tplan, jm, tm, tp, x, ref


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_interpret_plan(case):
    jplan, tplan, jm, tm, tp, x, ref = _case(*case)
    out = codegen.interpret_plan(tplan, tm, tp, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    assert codegen.plan_liveness(tplan, tm) == jax_codegen.plan_liveness(jplan, jm)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("liveness", [True, False])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_executor_on_cpu(case, liveness, fuse, coalesce):
    jplan, tplan, jm, tm, tp, x, ref = _case(*case)
    f = codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH,
                                    liveness=liveness, fuse_transfers=fuse, coalesce=coalesce)
    out = f(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    np.testing.assert_array_equal(f.eager(torch.from_numpy(x)).numpy(), out.numpy())
    kw = dict(batch=BATCH, fuse_transfers=fuse, coalesce=coalesce)
    expect = jax_codegen.executed_comm_bytes(jplan, jm, **kw)
    assert codegen.executed_comm_bytes(tplan, tm, **kw) == expect
    assert f.comm_bytes == expect
    assert f.streams == [] and f.streams_used == set()


@pytest.mark.parametrize("case", CASES[:3], ids=IDS[:3])
def test_executor_per_node_bytes_equal_plan_accounting(case):
    """Unfused, the executor copies exactly the plan's windowed payloads:
    ``plan.comm_bytes`` over the producers' f32 bytes, times the batch."""
    _jplan, tplan, _jm, tm, tp, x, _ref = _case(*case)
    f = codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH,
                                    fuse_transfers=False)
    f(torch.from_numpy(x))
    out_bytes = {l.name: l.out_bytes() for l in tm.layers}
    assert f.comm_bytes == pytest.approx(tplan.comm_bytes(out_bytes) * BATCH)


def _under_boxed_plan(cd):
    """LeNet-5 on two workers, where worker 1 is sent only rows 0-9 of
    conv1 but reads all 28: the box-inference bug the zero-born registers
    make visible."""
    rest = ("pool1", "conv2", "pool2", "flatten", "dense1", "dense2", "dense3", "output")
    return cd.ExecutionPlan(
        n_workers=2,
        steps=(cd.Superstep((("input", "conv1"), ()),
                            (cd.Transfer("conv1", 0, 1, ((0, 10), (0, 28), (0, 6))),)),
               cd.Superstep(((), rest), ())),
        makespan=0.0, sink="output", sink_worker=1)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("liveness", [True, False])
def test_windowed_transfer_lands_in_a_zero_born_register(liveness, fuse):
    """Outside its box a windowed transfer's register holds zeros, as in
    the reference's oracle: on a plan that ships too small a box, the
    executor gives the reference interpreter's (wrong) answer, not the
    sequential one."""
    pnp, x = numpy_params("lenet5"), numpy_input("lenet5")
    jp = {k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in pnp.items()}
    tp = cnn_params_from_numpy(pnp, device="cpu")
    jm, tm = jax_model("lenet5"), torch_model("lenet5")
    ref = np.asarray(jax_codegen.interpret_plan(_under_boxed_plan(jax_codegen), jm, jp,
                                                jnp.asarray(x)))
    plan = _under_boxed_plan(codegen)
    f = codegen.build_mpmd_executor(plan, tm, tp, device="cpu", batch=BATCH,
                                    liveness=liveness, fuse_transfers=fuse)
    out = f(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(codegen.interpret_plan(plan, tm, tp, torch.from_numpy(x)).numpy(),
                               ref, **TOL)
    seq = np.asarray(jax_cnn.run_sequential(jm, jp, jnp.asarray(x)))
    assert np.abs(out - seq).max() > 1e-3
    assert f.comm_bytes == BATCH * 10 * 28 * 6 * 4


def test_executor_checks_its_input():
    _jplan, tplan, _jm, tm, tp, x, _ref = _case("lenet5", "grid", "dsh", 4)
    f = codegen.build_mpmd_executor(tplan, tm, tp, device="cpu", batch=BATCH)
    with pytest.raises(ValueError, match="batch=2"):
        f(torch.from_numpy(x[:1]))
    with pytest.raises(ValueError, match="batch=2"):
        f.eager(torch.from_numpy(np.concatenate([x, x])))
    with pytest.raises(ValueError, match="input shape"):
        f(torch.from_numpy(x[..., :-1]))


def test_executor_default_device_is_the_card():
    _jplan, tplan, _jm, tm, tp, _x, _ref = _case("lenet5", "grid", "dsh", 4)
    if torch.cuda.is_available():
        assert len(codegen.build_mpmd_executor(tplan, tm, tp).streams) == 4
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            codegen.build_mpmd_executor(tplan, tm, tp)
