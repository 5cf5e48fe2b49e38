"""Jamba's hybrid ``super`` segment in the port against the JAX package's.

Both packages get the same weights: the reference's ``init_params`` tree for
the reduced ``jamba-v0.1-52b`` (4 layers, one ``super`` period: attention at
position 1, mamba2 mixers at 0, 2 and 3, MoE FFNs at the odd positions and
dense SwiGLU FFNs at the even ones, rope off), handed over as numpy through
``params_from_numpy``.  Inputs are drawn with numpy from a seed.

Tolerances, on outputs relative to their largest magnitude, as
``tests/test_torch_serve.py`` sets them: f32 1e-4 (summation order, the
scan's sequential form against the reference's chunked one, flash against
``chunked_attention``); bf16 5e-2 (the reference rounds more intermediates to
bf16).  Cache entries: the f32 state within atol 1e-4 + rtol 1e-4, the bf16
k/v and conv windows within 2 bf16 ulps.  Routing is exact in f32 (the
router is f32 in both packages).

The whole model is held in f32 only, as Arctic's is in
``tests/test_torch_mla.py``: over its four layers, two of them MoE, the
reference's own bf16 logits sit 0.084-0.092 of the largest from the same
weights run in f32, and the port's 0.059-0.097 (measured, seeds 0, 1, 5), so
two bf16 runs differ by more than 5e-2 from rounding alone.  Each layer of
the ``super`` period is held in bf16 too (``test_super_block``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_T
from repro.serve import Engine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import (
    SSMBlock, decode_step, forward, init_cache, init_params, layer_plan, segments,
)
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import _conv_in

ARCH = "jamba-v0.1-52b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5, 1, 2, 3, 4]]  # test_train_serve_elastic.py:74


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per dtype."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    return {"bfloat16": (jcfg, cfg, params),
            "float32": (jcfg, cfg, jax.tree.map(lambda a: a.astype(jnp.float32), params))}


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(out, ref, dtype):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


def _cache_close(out, ref, dtype, name):
    assert out.dtype == getattr(torch, str(ref.dtype)), (name, out.dtype, ref.dtype)
    if dtype == "bfloat16":
        _close(out, ref, dtype)
    elif name == "ssd":
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2.0 ** -6, atol=1e-3)


def _cache_leaves(cache):
    return {(seg, pj, n): t for seg, ps in cache["segments"].items()
            for pj, leaves in ps.items() for n, t in leaves.items()}


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_segments_and_layer_plan():
    """The reduced config's one ``super`` period and the full config's four:
    attention at the config's offset, MoE at the odd positions, the rest
    mamba2 mixers with dense FFNs; the structure equals the reference's."""
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_config(ARCH).reduced(), jax_get_config(ARCH).reduced())):
        assert segments(cfg) == jax_T.segments(jcfg)
        (seg,) = segments(cfg)
        P = cfg.hybrid.attn_period
        assert seg["name"] == "super" and seg["repeat"] == cfg.n_layers // P
        assert seg["pattern"] == [("attn" if j == cfg.hybrid.attn_offset else "ssm",
                                   "moe" if j % 2 else "dense") for j in range(P)]
        plan = layer_plan(cfg)
        assert [(s.k, s.j) for s in plan] == [(k, j) for k in range(seg["repeat"])
                                              for j in range(P)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_covers_the_super_segment(weights, dtype):
    """Every leaf of ``segments/super/p<j>`` lands in its layer, the SSM
    positions' ``ln2``/``mlp``/``moe`` leaves included; the SSM's f32 leaves
    and the router stay f32 in a bf16 model."""
    _, cfg, params = weights[dtype]
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(cfg, tree, device="cpu")
    n_leaves, ffn_on_ssm = 0, set()
    for name, prm in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            continue
        slot = model.plan[int(parts[1])]
        node = tree["segments"][slot.segment][f"p{slot.j}"]
        for key in parts[2:]:
            node = node[key]
        np.testing.assert_array_equal(_f32(prm), np.asarray(node, np.float32)[slot.k])
        f32 = parts[-1] in ("router", "dt_bias", "A_log", "Dskip")
        assert prm.dtype == (torch.float32 if f32 else getattr(torch, dtype)), name
        if slot.mixer == "ssm" and parts[2] in ("ln2", "mlp", "moe"):
            ffn_on_ssm.add((slot.j, parts[2]))
        n_leaves += 1
    assert n_leaves == sum(np.asarray(a).shape[0] for a in jax.tree.leaves(params["segments"]))
    assert ffn_on_ssm == {(0, "ln2"), (0, "mlp"), (2, "ln2"), (2, "mlp"), (3, "ln2"), (3, "moe")}
    assert [type(b) is SSMBlock for b in model.layers] == [True, False, True, True]


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", ["float32"])
class TestModel:
    def test_forward_train(self, weights, dtype, impl):
        """45 tokens: two router chunks of 32 (the second padded), three SSD
        chunks of 16 (the last ragged)."""
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(0, (2, 45), cfg.vocab)
        ref = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, moe_impl=impl)
        out = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)}, moe_impl=impl)
        assert out.dtype == getattr(torch, dtype)
        _close(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, dtype, impl):
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(1, (2, 13), cfg.vocab)
        ref, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 32), moe_impl=impl)
        out, cache = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)},
                             mode="prefill",
                             cache=_conv_in(init_cache(cfg, 2, 32, device="cpu"),
                                            getattr(torch, dtype)),
                             moe_impl=impl)
        _close(out, ref, dtype)
        leaves, jleaves = _cache_leaves(cache), _cache_leaves(jcache)
        assert set(leaves) == set(jleaves)
        assert {n for (_, _, n) in leaves} == {"k", "v", "conv", "ssd"}
        for key, t in leaves.items():
            _cache_close(t, jleaves[key], dtype, key[2])
        assert int(cache["pos"]) == int(jcache["pos"]) == 13

    def test_decode_step_per_slot_positions(self, weights, dtype, impl):
        """One decode tick with a ragged per-slot position vector, on the same
        (reference-prefilled) cache for both: the attention layer's k/v and
        the mixers' conv windows and states."""
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(2, (3, 12), cfg.vocab)
        _, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                  cache=jax_T.init_cache(jcfg, 3, 32))
        cache = {"segments": {seg: {pj: {n: tensor_from_numpy(np.asarray(a))
                                         for n, a in leaves.items()}
                                    for pj, leaves in ps.items()}
                              for seg, ps in jcache["segments"].items()}}
        pos = np.array([12, 7, 10])
        jcache["pos"], cache["pos"] = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
        step = _tokens(3, (3, 1), cfg.vocab)
        ref, jcache = jax_T.decode_step(params, jcfg, jcache, jnp.asarray(step), moe_impl=impl)
        out, cache = decode_step(_port(cfg, params), cfg, cache, torch.from_numpy(step),
                                 moe_impl=impl)
        _close(out, ref, dtype)
        jleaves = _cache_leaves(jcache)
        for key, t in _cache_leaves(cache).items():
            _cache_close(t, jleaves[key], dtype, key[2])
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [0, 1, 2, 3])
def test_super_block(weights, j, dtype):
    """Position j of the ``super`` period alone (0 and 2: mixer + dense FFN,
    1: attention + MoE, 3: mixer + MoE), train mode, 45 positions: the
    reference's ``block_apply`` against the port's layer."""
    jcfg, cfg, params = weights[dtype]
    mixer = "attn" if j == cfg.hybrid.attn_offset else "ssm"
    bp = jax.tree.map(lambda a: a[0], params["segments"]["super"][f"p{j}"])
    a = (np.random.default_rng(10 + j).standard_normal((2, 45, cfg.d_model))).astype(np.float32)
    jx = jnp.asarray(a).astype(getattr(jnp, dtype))
    ref, _ = jax_T.block_apply(bp, jcfg, jx, None, None, "train", mixer)
    block = _port(cfg, params).layers[j]
    out = block(cfg, torch.from_numpy(a).to(getattr(torch, dtype)), None, None, "train")
    _close(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_teacher_forcing(weights, dtype):
    """Port of ``tests/test_models_smoke.py::test_decode_matches_teacher_forcing``
    for Jamba: capacity drops off (capacity factor 64), the reference's
    tokens (``jax.random.randint`` from its key): prefill 8, then decode the
    next 4 teacher-forced.  f32: each step's logits equal the reference's
    decode steps within 1e-4 of their largest (both round k/v and conv
    windows to the bf16 cache, so both sit ~0.028 from their train
    forwards).  bf16: each step's logits against the port's own train
    forward within 5e-2 of their largest (the reference's sit exactly on
    its own; the port's decode attention rounds probabilities to bf16 where
    the flash route keeps them f32: 0.11 of 3.8, measured)."""
    jcfg, cfg, params = weights[dtype]
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=64.0))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 12), 0, cfg.vocab))
    model = _port(cfg, params)
    t = torch.from_numpy(toks)
    full = forward(model, cfg, {"tokens": t})
    cache = _conv_in(init_cache(cfg, 2, 32, device="cpu"), model.embed.dtype)
    _, cache = forward(model, cfg, {"tokens": t[:, :8]}, mode="prefill", cache=cache)
    _, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks[:, :8])}, mode="prefill",
                              cache=jax_T.init_cache(jcfg, 2, 32))
    for i in range(8, 12):
        lg, cache = decode_step(model, cfg, cache, t[:, i:i + 1])
        ref, jcache = jax_T.decode_step(params, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]))
        if dtype == "float32":
            _close(lg, ref, dtype)
        else:
            _close(lg[:, 0], full[:, i], dtype)


def test_scatter_matches_einsum(weights):
    """Port of ``tests/test_models_smoke.py::test_moe_scatter_matches_einsum``
    for Jamba (bf16, 32 tokens, the reference's bound 5e-2)."""
    _, cfg, params = weights["bfloat16"]
    model = _port(cfg, params)
    toks = torch.from_numpy(_tokens(4, (2, 32), cfg.vocab))
    a = forward(model, cfg, {"tokens": toks}, moe_impl="einsum").float()
    b = forward(model, cfg, {"tokens": toks}, moe_impl="scatter").float()
    assert float((a - b).abs().max()) < 5e-2


def test_engine_tokens_equal_jax_engine(weights):
    """f32 weights: the port's engine emits exactly the reference engine's
    tokens over a pool that holds k/v, conv windows and states, and ends
    with the same pool (the scatter dispatch is held in the model tests and
    in ``tests/test_torch_moe.py``'s engine tests)."""
    jcfg, cfg, params = weights["float32"]
    jeng = JaxEngine(jcfg, params, JaxServeConfig(max_seq=64, slots=3))
    jreqs = [jeng.submit(p, max_new=5) for p in PROMPTS]
    jeng.run_until_done()
    eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=3), device="cpu")
    reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
    eng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    jleaves = _cache_leaves(jeng.cache)
    for key, t in _cache_leaves(eng.cache).items():
        _cache_close(t, jleaves[key], "float32", key[2])


def test_init_params_follows_param_defs():
    """``init_params`` gives the reference's leaves, shapes, dtypes and
    initializers for the ``super`` segment: the mixers' f32 leaves, an f32
    router, ones for norms, zeros for biases, normals at ``default_scale``
    (``conv_w`` at 1/conv_width)."""
    cfg = get_config(ARCH).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax_T.abstract_params(jax_get_config(ARCH).reduced())
    ported = params_from_numpy(cfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref),
                               device="cpu")
    assert [(n, p.shape, p.dtype) for n, p in ported.named_parameters()] == [
        (n, p.shape, p.dtype) for n, p in model.named_parameters()]
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "Dskip", "norm"):
            assert bool((p == 1).all()), name
        elif leaf in ("dt_bias", "A_log", "conv_b"):
            assert bool((p == 0).all()), name
        else:
            want = {"embed": 0.02, "conv_w": 1 / cfg.ssm.conv_width}.get(leaf, p.shape[-2] ** -0.5)
            assert abs(float(p.float().std()) / want - 1) < 0.15, name
