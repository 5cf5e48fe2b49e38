"""The port's AdamW, schedule and clipping against the JAX package's.

Both run on the same trees, flat dicts of numpy draws (a flat dict is a
pytree for the reference and the port's ``{name: tensor}``), with the same
gradients, for several steps.  Tolerances:
* f32 leaves: rtol 1e-5, atol 1e-7.  Both compute in f32 and differ in the
  order of the global norm's sums and in fused multiply-adds, which moves
  the last bits of a step; over 6 steps the largest relative difference
  reads ~1e-6.
* bf16 leaves (parameters, or moments under ``bf16_moments``): one bf16
  ulp (rtol 2**-7): a last-bit difference in f32 can round the other way.
* The schedule and the norms: rtol 1e-6.
``tests/test_substrates.py::TestOptim``'s scenarios run on the port too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jax_adamw
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, clip_by_global_norm, cosine_schedule, global_norm,
)

SHAPES = {"embed": (50, 16), "layers.0.attn.wq": (16, 4, 4), "final_norm.scale": (16,)}


def _draw(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _jax_cfg(cfg: AdamWConfig):
    return jax_adamw.AdamWConfig(**dataclasses.asdict(cfg))


def _close(ours: torch.Tensor, ref, rtol=1e-5, atol=1e-7):
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    if ours.dtype == torch.bfloat16:
        rtol, atol = 2.0 ** -7, 0.0
    np.testing.assert_allclose(ours.float().numpy(), ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 1, 3, 10, 55, 100, 150])
def test_cosine_schedule(step):
    cfg = AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    ours = cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    ref = jax_adamw.cosine_schedule(_jax_cfg(cfg), jnp.asarray(step, jnp.int32))
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), rel=1e-6, abs=1e-12)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_global_norm_and_clipping(scale):
    g = _draw(1, scale)
    ours, gn = clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    ref, rgn = jax_adamw.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    assert float(gn) == pytest.approx(float(rgn), rel=1e-6)
    assert float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})) == \
        pytest.approx(float(jax_adamw.global_norm(g)), rel=1e-6)
    for k in g:
        _close(ours[k], ref[k], rtol=1e-6)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_moments", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clipping off, then on
def test_adamw_steps_equal_reference(param_dtype, bf16_moments, grad_scale):
    cfg = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=8, bf16_moments=bf16_moments)
    jcfg = _jax_cfg(cfg)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    p0 = _draw(0)
    ours = {k: torch.tensor(v).to(tdt) for k, v in p0.items()}  # a copy: updated in place
    ref = {k: jnp.asarray(v).astype(jdt) for k, v in p0.items()}
    ostate, rstate = adamw_init(ours, cfg), jax_adamw.adamw_init(ref, jcfg)
    mdt = torch.bfloat16 if bf16_moments else torch.float32
    assert all(m.dtype == mdt for m in ostate["m"].values())
    for step in range(6):
        g = _draw(10 + step, grad_scale)
        ours, ostate, om = adamw_update(ours, {k: torch.from_numpy(v).to(tdt)
                                               for k, v in g.items()}, ostate, cfg)
        ref, rstate, rm = jax_adamw.adamw_update(ref, {k: jnp.asarray(v).astype(jdt)
                                                       for k, v in g.items()}, rstate, jcfg)
        assert ostate["step"].dtype == torch.int32 and int(ostate["step"]) == step + 1
        assert float(om["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(om["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-5)
        for k in SHAPES:
            _close(ours[k], ref[k])
            _close(ostate["m"][k], rstate["m"][k])
            _close(ostate["v"][k], rstate["v"][k])


def test_update_writes_in_place():
    cfg = AdamWConfig()
    params = {"w": torch.ones(4)}
    w, st = params["w"], adamw_init(params, cfg)
    m = st["m"]["w"]
    params, st, _ = adamw_update(params, {"w": torch.ones(4)}, st, cfg)
    assert params["w"] is w and st["m"]["w"] is m
    assert not torch.equal(w, torch.ones(4))


# tests/test_substrates.py::TestOptim on the port
def test_quadratic_convergence():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=400, grad_clip=1e9)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = adamw_init(params, cfg)
    for _ in range(300):
        params, state, _ = adamw_update(params, {"x": 2 * params["x"]}, state, cfg)
    assert float(params["x"].abs().max()) < 1e-2


def test_grad_clipping():
    clipped, gn = clip_by_global_norm({"a": torch.full((10,), 100.0)}, 1.0)
    assert float(gn) > 100
    assert float(global_norm(clipped)) <= 1.0 + 1e-5


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(cosine_schedule(cfg, torch.tensor(0))) == 0.0
    assert float(cosine_schedule(cfg, torch.tensor(10))) == pytest.approx(1.0)
    assert float(cosine_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1)


def test_bf16_moments_halve_memory():
    params = {"w": torch.zeros((64, 64))}
    s32 = adamw_init(params, AdamWConfig(bf16_moments=False))
    s16 = adamw_init(params, AdamWConfig(bf16_moments=True))
    assert s16["m"]["w"].dtype == torch.bfloat16
    assert s16["m"]["w"].nbytes * 2 == s32["m"]["w"].nbytes


def test_step_counter():
    params = {"x": torch.ones(3)}
    st = adamw_init(params, AdamWConfig())
    _, st, _ = adamw_update(params, {"x": torch.ones(3)}, st, AdamWConfig())
    assert int(st["step"]) == 1 and st["step"].dtype == torch.int32
