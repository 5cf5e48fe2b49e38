"""Cases shared by the CNN-pipeline parity tests (``test_torch_cnn.py``,
``test_torch_plan.py``, ``test_torch_executor.py``, ``test_torch_analyze.py``,
``test_torch_faults.py``): the four model builders
at small sizes, the slicings they are held in, and weights and inputs drawn
with numpy from a seed, which cross to both packages as numpy arrays (the
reference's own ``init_params`` folds in ``hash(name)``, salted per
process)."""
import numpy as np

import repro.core.costmodel as jax_costmodel
import repro.models.cnn as jax_cnn
import repro.models.slicing as jax_slicing
import repro_torch.core.costmodel as torch_costmodel
import repro_torch.models.cnn as torch_cnn
import repro_torch.models.slicing as torch_slicing

BATCH = 2
BUILDERS = {
    "lenet5": lambda cnn: cnn.lenet5(28),
    "lenet5_branchy": lambda cnn: cnn.lenet5_branchy(28),
    "inception": lambda cnn: cnn.inception_net(32),
    "transformer": lambda cnn: cnn.transformer_block(seq=16, d_model=32, n_heads=4, d_ff=64),
}
# whole; 4 channel tiles; 4 row tiles; the cost model's (cout x rows) grids;
# 4 channel tiles reassembled through tile_concat glue (direct=False)
SLICINGS = ("whole", "channel", "rows", "grid", "concat")


def _build(cnn, slicing_mod, costmodel, builder: str, slicing: str):
    model = BUILDERS[builder](cnn)
    if slicing == "whole":
        return model
    if slicing == "grid":
        return slicing_mod.slice_model(
            model, slicing_mod.choose_slice_factors(model, costmodel.KEYSTONE_CPU))
    factors = slicing_mod.uniform_factors(model, 4, spatial=slicing == "rows")
    return slicing_mod.slice_model(model, factors, direct=slicing != "concat")


def jax_model(builder: str, slicing: str = "whole"):
    return _build(jax_cnn, jax_slicing, jax_costmodel, builder, slicing)


def torch_model(builder: str, slicing: str = "whole"):
    return _build(torch_cnn, torch_slicing, torch_costmodel, builder, slicing)


def numpy_params(builder: str, seed: int = 0):
    """``{layer: {"w", "b"}}`` at the reference's scales, with small nonzero
    biases so that bias slicing shows."""
    return numpy_params_of(BUILDERS[builder](jax_cnn), seed)


def numpy_params_of(model, seed: int = 0):
    """``numpy_params`` for any (unsliced) model of either package."""
    rng = np.random.default_rng(seed)
    params = {}
    for l in model.layers:
        a = l.attrs
        if l.op == "conv":
            cin = a["in_shape"][2]
            shape, fan_in = (a["kernel"], a["kernel"], cin, a["features"]), a["kernel"] ** 2 * cin
        elif l.op == "dense":
            shape, fan_in = (a["in_features"], a["features"]), a["in_features"]
        else:
            continue
        params[l.name] = {
            "w": (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(a["features"])).astype(np.float32),
        }
    return params


def numpy_input(builder: str, seed: int = 1, batch: int = BATCH):
    shape = BUILDERS[builder](jax_cnn).layers[0].out_shape
    return np.random.default_rng(seed).standard_normal((batch, *shape)).astype(np.float32)
