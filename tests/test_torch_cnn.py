"""The port's CNN compute (``repro_torch.models.cnn``) against the JAX
package's on the CPU: ``apply_layer`` op by op on the reference's own
inputs, and ``run_sequential`` whole and sliced, for the four builders at
small sizes (batch 2) and every slicing of ``_torch_cnn_cases.SLICINGS``
(channel, row, grid and uniform-with-glue tilings; stride-2 convolutions
with asymmetric SAME pads and inception's global average pool among them).

Tolerance: ``rtol = atol = 1e-5`` in f32.  Largest absolute error measured
on the CPU over every case: 5.2e-6 op by op (the transformer block, whose
values reach ~5) and 9.5e-7 for ``run_sequential``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.models.cnn as jax_cnn
from _torch_cnn_cases import (
    BUILDERS, SLICINGS, jax_model, numpy_input, numpy_params, torch_model,
)
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.models import cnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _params(builder):
    p = numpy_params(builder)
    return ({k: {n: jnp.asarray(v) for n, v in d.items()} for k, d in p.items()},
            cnn_params_from_numpy(p, device="cpu"))


@pytest.mark.parametrize("slicing", SLICINGS)
@pytest.mark.parametrize("builder", BUILDERS)
def test_apply_layer_op_by_op(builder, slicing):
    """Each layer of the port, fed the reference's values of its inputs,
    gives the reference's output."""
    jm, tm = jax_model(builder, slicing), torch_model(builder, slicing)
    jp, tp = _params(builder)
    vals = {}
    for lj, lt in zip(jm.layers, tm.layers):
        assert lj.name == lt.name
        ins = [numpy_input(builder)] if lj.op == "input" else [vals[p] for p in lj.inputs]
        ref = np.asarray(jax_cnn.apply_layer(lj, jp, [jnp.asarray(a) for a in ins]))
        out = cnn.apply_layer(lt, tp, [torch.from_numpy(np.array(a)) for a in ins])
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), ref, **TOL, err_msg=f"{lj.name} ({lj.op})")
        vals[lj.name] = ref


@pytest.mark.parametrize("slicing", SLICINGS)
@pytest.mark.parametrize("builder", BUILDERS)
def test_run_sequential(builder, slicing):
    """The sliced model's output equals the reference's unsliced one."""
    jp, tp = _params(builder)
    x = numpy_input(builder)
    ref = np.asarray(jax_cnn.run_sequential(jax_model(builder), jp, jnp.asarray(x)))
    out = cnn.run_sequential(torch_model(builder, slicing), tp, torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_float64_run_is_a_reference():
    """The port's f64 run, which ``chip_smoke.py`` holds the card to, agrees
    with the JAX package's f32 run within chip_smoke's tolerance."""
    builder = "inception"
    jp, _ = _params(builder)
    tp = {k: {n: torch.from_numpy(v).double() for n, v in d.items()}
          for k, d in numpy_params(builder).items()}
    x = numpy_input(builder)
    ref = np.asarray(jax_cnn.run_sequential(jax_model(builder), jp, jnp.asarray(x)))
    out = cnn.run_sequential(torch_model(builder), tp, torch.from_numpy(x).double())
    assert out.dtype == torch.float64
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


def test_cases_cover_asymmetric_pads_and_global_avgpool():
    """The slicings reach what the op semantics must get right: a stride-2
    layer whose SAME pads are asymmetric, row tiles with halo pads, and a
    global average pool (kernel = stride = input height)."""
    model = torch_model("inception")
    conv1 = model.spec("conv_1")
    lo, hi, _ = cnn._same_pads(conv1.attrs["in_shape"][0], conv1.attrs["kernel"],
                               conv1.attrs["stride"])
    assert conv1.attrs["stride"] == 2 and lo != hi
    pool = model.spec("avgpool")
    assert pool.attrs["kernel"] == pool.attrs["stride"] == pool.attrs["in_shape"][0]
    rows = torch_model("inception", "rows")
    pads = set()
    for l in rows.layers:
        if l.op == "conv_slice" and l.attrs.get("stride", 1) == 2:
            h = l.attrs["in_shape"][0]
            _a, _b, plo, phi = cnn._row_window(l.attrs["r_lo"], l.attrs["r_hi"], h,
                                                l.attrs["kernel"], 2)
            pads.add((plo, phi))
    assert (0, 0) in pads and any(plo != phi for plo, phi in pads)


@pytest.mark.parametrize("builder", BUILDERS)
def test_init_params_shapes_and_scales(builder):
    """The port's own weights (for runs without JAX) have the reference's
    leaves, shapes and scales, and a seed fixes them."""
    model = torch_model(builder)
    ours = model.init_params(0, device="cpu")
    again = model.init_params(0, device="cpu")
    ref = numpy_params(builder)
    assert ours.keys() == ref.keys()
    for name, leaves in ours.items():
        assert {k: tuple(v.shape) for k, v in leaves.items()} == \
            {k: v.shape for k, v in ref[name].items()}
        w = leaves["w"]
        fan_in = int(np.prod(w.shape[:-1]))
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.25, name
        assert not leaves["b"].any()
        assert torch.equal(w, again[name]["w"])
    assert not torch.equal(ours[next(iter(ours))]["w"],
                           model.init_params(1, device="cpu")[next(iter(ours))]["w"])


def test_init_params_default_device_is_the_card():
    """Entry points run on CUDA unless the caller asks for the CPU."""
    model = torch_model("lenet5")
    if torch.cuda.is_available():
        assert next(iter(model.init_params(0)["conv1"].values())).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model.init_params(0)
