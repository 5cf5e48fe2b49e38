"""The port's dense LM and serving engine against the JAX package's.

Both packages get the same weights: the reference's ``init_params`` tree,
handed over as numpy through ``params_from_numpy``.  Configs are the
reduced tinyllama-1.1b, qwen2-0.5b (QKV bias, tied embeddings) and qwen3-32b
(qk-norm).

Tolerances, on logits relative to their largest magnitude:
* f32 (params cast to f32 on both sides; the KV cache stays bf16, as in the
  reference): 1e-4.  The two differ in summation order and in prefill
  attention (the port's flash route against the reference's chunked jnp).
* bf16: 5e-2.  The reference rounds the gate/up products and ``silu(g)`` to
  bf16 before multiplying, the fused SwiGLU does not; XLA and PyTorch round
  bf16 matmul outputs in different places (measured: up to 2.4e-2).
Cache entries are bf16 in both.  In the f32 runs they agree within 2 bf16
ulps (rtol 2**-6); in the bf16 runs the layers' inputs already differ as
the logits do, so the cache takes the logits' tolerance.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import layers as jax_layers
from repro.models import transformer as jax_T
from repro.serve import Engine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, layers, synth_inputs, transformer,
)
from repro_torch.serve import Engine, ServeConfig

ARCHS = ["tinyllama-1.1b", "qwen2-0.5b", "qwen3-32b"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5, 1, 2, 3, 4]]  # test_train_serve_elastic.py:74


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per (arch, dtype)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch).reduced()
        params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
        out[arch, "bfloat16"] = (jcfg, get_config(arch).reduced(), params)
        out[arch, "float32"] = (jcfg, get_config(arch).reduced(),
                                jax.tree.map(lambda a: a.astype(jnp.float32), params))
    return out


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_logits(out, ref, dtype):
    out, ref = _f32(out), _f32(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL[dtype] * np.abs(ref).max())


def _assert_cache(tcache, jcache, dtype):
    for name in ("k", "v"):
        t = tcache["segments"]["dense"]["p0"][name]
        j = _f32(jcache["segments"]["dense"]["p0"][name])
        assert t.dtype == torch.bfloat16
        if dtype == "float32":
            np.testing.assert_allclose(_f32(t), j, rtol=2.0 ** -6, atol=1e-3)
        else:
            np.testing.assert_allclose(_f32(t), j, rtol=0, atol=LOGIT_TOL[dtype] * np.abs(j).max())


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
class TestModelParity:
    def test_forward_train(self, weights, arch, dtype):
        jcfg, cfg, params = weights[arch, dtype]
        toks = _tokens(0, (2, 20), cfg.vocab)
        ref = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="train")
        out = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)}, mode="train")
        assert out.shape == (2, 20, cfg.vocab) and out.dtype == getattr(torch, dtype)
        _assert_logits(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, arch, dtype):
        jcfg, cfg, params = weights[arch, dtype]
        toks = _tokens(1, (2, 13), cfg.vocab)
        ref, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 32))
        out, cache = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)},
                             mode="prefill", cache=init_cache(cfg, 2, 32, device="cpu"))
        _assert_logits(out, ref, dtype)
        _assert_cache(cache, jcache, dtype)
        assert int(cache["pos"]) == int(jcache["pos"]) == 13

    def test_decode_step_per_slot_positions(self, weights, arch, dtype):
        """One decode tick with a ragged per-slot position vector, on the
        same (reference-prefilled) cache for both."""
        jcfg, cfg, params = weights[arch, dtype]
        toks = _tokens(2, (3, 12), cfg.vocab)
        _, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                  cache=jax_T.init_cache(jcfg, 3, 32))
        cache = {"segments": {"dense": {"p0": {
            n: tensor_from_numpy(np.asarray(jcache["segments"]["dense"]["p0"][n]))
            for n in ("k", "v")}}}}
        pos = np.array([12, 7, 10])
        jcache["pos"], cache["pos"] = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
        step = _tokens(3, (3, 1), cfg.vocab)
        ref, jcache = jax_T.decode_step(params, jcfg, jcache, jnp.asarray(step))
        out, cache = decode_step(_port(cfg, params), cfg, cache, torch.from_numpy(step))
        _assert_logits(out, ref, dtype)
        _assert_cache(cache, jcache, dtype)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


@pytest.mark.parametrize("pos", [[3, 40, 7], 40, 5])
def test_cache_write_out_of_range_as_reference(pos):
    """A vector position past the end drops that row's write; a scalar one
    is clamped to the last entry (the reference's ``.at[].set`` and
    ``dynamic_update_slice``)."""
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((3, 32, 2, 4)).astype(np.float32)
    val = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    ref = jax_layers.cache_write(jnp.asarray(arr), jnp.asarray(val), jnp.asarray(pos))
    out = layers.cache_write(torch.from_numpy(arr.copy()), torch.from_numpy(val),
                             torch.tensor(pos))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


class TestEngine:
    def test_tokens_equal_jax_engine(self, weights):
        """f32 weights: the port's engine emits exactly the reference engine's tokens."""
        jcfg, cfg, params = weights["tinyllama-1.1b", "float32"]
        jeng = JaxEngine(jcfg, params, JaxServeConfig(max_seq=64, slots=3))
        jreqs = [jeng.submit(p, max_new=5) for p in PROMPTS]
        jeng.run_until_done()
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=3), device="cpu")
        reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
        eng.run_until_done()
        assert [r.out for r in reqs] == [r.out for r in jreqs]

    def test_engine_matches_reference(self, weights):
        """Port of ``test_train_serve_elastic.py::test_engine_matches_reference``:
        engine tokens == teacher-forced greedy decoding, bf16 weights."""
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        model = _port(cfg, params)
        eng = Engine(cfg, model, ServeConfig(max_seq=64, slots=3), device="cpu")
        reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
        eng.run_until_done()
        for r, p in zip(reqs, PROMPTS):
            toks, ref = list(p), []
            for _ in range(5):
                lg = forward(model, cfg, {"tokens": torch.tensor(toks)[None]}, mode="train")
                t = int(torch.argmax(lg[0, -1]))
                ref.append(t)
                toks.append(t)
            assert r.out == ref, (r.out, ref)

    def test_slot_reuse(self, weights):
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=2), device="cpu")
        reqs = [eng.submit([i + 1], max_new=3) for i in range(5)]
        eng.run_until_done()
        assert all(r.done and len(r.out) == 3 for r in reqs)

    def test_finish_at_prefill(self, weights):
        """max_new=1 finishes at admission: one token, no slot, no decode tick."""
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=2), device="cpu")
        r = eng.submit([1, 2, 3], max_new=1)
        assert eng.tick() == 0
        assert r.done and len(r.out) == 1
        assert eng.slot_req == [None, None]

    def test_degraded_admits_one_per_tick(self, weights):
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=3), device="cpu")
        for i in range(3):
            eng.submit([i + 1, 2], max_new=4)
        eng.degraded = True
        assert eng.tick() == 1
        assert eng.tick() == 2
        eng.degraded = False
        assert eng.tick() == 3

    def test_health_check_degrades_and_publishes_plan(self, weights):
        """The duck-typed monitor/planner wiring, with stand-ins for both."""
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]

        class Monitor:
            def __init__(self):
                self.steps, self.verdict = [], {"dead": [], "stragglers": [2]}

            def check(self, certificate=None, slack=1.0):
                return self.verdict

            def record_step(self, step, dt, worker=0):
                self.steps.append((step, worker))

        class Planner:
            def replan(self, monitor, certificate=None, slack=1.0):
                return dataclasses.make_dataclass("Plan", ["action"])("shrink")

        mon = Monitor()
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=2), monitor=mon,
                     planner=Planner(), check_every=1, device="cpu")
        eng.tick()
        assert eng.degraded and eng.elastic_plan.action == "shrink"
        assert mon.steps == [(1, 0)]
        mon.verdict = {"dead": [], "stragglers": []}
        eng.tick()
        assert not eng.degraded


class TestDevices:
    def test_entry_points_default_to_cuda_and_raise_without_it(self, weights, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        tree = jax.tree.map(np.asarray, params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            params_from_numpy(cfg, tree)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Engine(cfg, _port(cfg, params))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            synth_inputs(cfg, 1, 8, torch.Generator())

    def test_engine_refuses_params_on_another_device(self, weights):
        _, cfg, params = weights["tinyllama-1.1b", "bfloat16"]
        with pytest.raises(ValueError, match="params are on"):
            Engine(cfg, _port(cfg, params), device="meta")


@pytest.mark.parametrize("arch", jax_list_archs())
def test_every_registry_config_runs(arch):
    """Every config of the registry builds on the CPU at its reduced size and
    runs: one train forward over its frontend's inputs (frames, image rows
    and text, or text), finite logits of the expected shape, and a prefill
    whose logits equal the train forward's."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    inputs = synth_inputs(cfg, 2, 12, torch.Generator().manual_seed(1), device="cpu")
    logits = forward(model, cfg, inputs)
    assert logits.shape == (2, 12, cfg.vocab) and bool(torch.isfinite(logits).all())
    pre, cache = forward(model, cfg, inputs, mode="prefill",
                         cache=init_cache(cfg, 2, 16, device="cpu"))
    torch.testing.assert_close(pre, logits, atol=1e-5, rtol=1e-5)
    assert int(cache["pos"]) == 12


# how init_params chose each leaf's initializer by its name before it read
# the ParamDef trees (the reference's initializers, written out)
_ONES = {"scale", "q_norm", "k_norm", "kv_norm", "Dskip", "norm"}
_ZEROS = {"bq", "bk", "bv", "dt_bias", "A_log", "conv_b"}


def _init_params_scaling_out_of_place(cfg, generator):
    """``init_params`` as it drew before it scaled in place and before it
    read the ``ParamDef`` trees: initializer by leaf name,
    ``prm.copy_(draw * scale)``, which holds a second f32 temporary."""
    model = transformer.Transformer(cfg, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ONES:
                prm.fill_(1.0)
            elif leaf in _ZEROS:
                prm.zero_()
            else:
                fan_in = prm.shape[-2] if prm.dim() >= 2 else prm.shape[-1]
                scale = (0.02 if leaf == "embed" else
                         1.0 / cfg.ssm.conv_width if leaf == "conv_w" else
                         1.0 / math.sqrt(max(fan_in, 1)))
                draw = torch.randn(prm.shape, generator=generator, device=generator.device)
                prm.copy_(draw * scale)
    return model


@pytest.mark.parametrize("arch", jax_list_archs())
def test_init_params_in_place_scaling_draws_the_same_bits(arch):
    """Reading each leaf's initializer from its ``ParamDef`` and scaling the
    draw in place gives bit for bit the weights that the name-driven,
    out-of-place draw gave, from one seed (so every earlier run's weights
    stand)."""
    cfg = get_config(arch).reduced()
    new = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    old = _init_params_scaling_out_of_place(cfg, torch.Generator().manual_seed(7))
    pairs = list(zip(new.named_parameters(), old.named_parameters()))
    assert pairs and all(a == b for (a, _), (b, _) in pairs)
    for (name, p), (_, q) in pairs:
        assert p.dtype == q.dtype and torch.equal(p, q), name


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_param_defs(arch):
    """``init_params`` gives the reference's shapes and initializers: ones
    for norms, zeros for biases, normals at ``default_scale``."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax_T.abstract_params(jax_get_config(arch).reduced())
    assert params_from_numpy(cfg, jax.tree.map(lambda s: np.zeros(s.shape, np.float32), ref),
                             device="cpu") is not None  # every port leaf exists, same shape
    for name, p in model.named_parameters():
        assert p.dtype == torch.bfloat16 and not p.requires_grad
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "q_norm", "k_norm"):
            assert bool((p == 1).all()), name
        elif leaf in ("bq", "bk", "bv"):
            assert bool((p == 0).all()), name
        else:
            want = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            assert abs(float(p.float().std()) / want - 1) < 0.15, name
