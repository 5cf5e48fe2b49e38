"""MLA attention and the whole DeepSeek-V2-Lite / Arctic models of the port
against the JAX package's.

Both packages get the same weights: the reference's ``init_params`` tree for
the reduced ``deepseek-v2-lite-16b`` (MLA, a ``lead`` dense layer, then
``moe`` layers with shared experts) and ``arctic-480b`` (GQA, ``moe``
layers with a dense residual), handed over as numpy through
``params_from_numpy``.  Layer-level tests read one layer's leaves out of
that tree.

Tolerances, on outputs relative to their largest magnitude:
* f32 (params cast to f32 on both sides; the caches stay bf16, as in the
  reference): 1e-4.  The port's prefill attention is the flash route (its
  plain version on the CPU) where the reference runs ``chunked_attention``;
  the decode products accumulate in f32 on both sides.
* bf16: 5e-2, as ``tests/test_torch_serve.py`` sets it: the reference rounds
  more intermediates to bf16 (the gate/up products, silu(g), each expert's
  output) than the fused kernels do.  Arctic's whole model is held in f32
  only: over its two MoE layers with a dense residual the reference's own
  bf16 logits sit 0.13 of the largest from the same weights run in f32, and
  the port's 0.10 (measured, seed 0), so the two bf16 runs differ by up to
  0.05 of rounding alone; its MoE layer is held in bf16 in
  ``tests/test_torch_moe.py``.
Cache entries are bf16 in both: in the f32 runs within 2 bf16 ulps (rtol
2**-6), in the bf16 runs within the logits' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import transformer as jax_T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import gqa_flash_attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, layer_plan, layers, segments,
)

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
MODELS = [("deepseek-v2-lite-16b", "float32"), ("deepseek-v2-lite-16b", "bfloat16"),
          ("arctic-480b", "float32")]


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per (arch, dtype)."""
    out = {}
    for arch in ("deepseek-v2-lite-16b", "arctic-480b"):
        jcfg = jax_get_config(arch).reduced()
        params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced()
        out[arch, "bfloat16"] = (jcfg, cfg, params)
        out[arch, "float32"] = (jcfg, cfg, jax.tree.map(lambda a: a.astype(jnp.float32), params))
    return out


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(out, ref, dtype):
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


def _cache_close(out, ref, dtype):
    assert out.dtype == torch.bfloat16
    if dtype == "float32":
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=2.0 ** -6, atol=1e-3)
    else:
        _close(out, ref, dtype)


def _layer(params, seg, k=0):
    """Layer k of segment ``seg``'s attention leaves: (jax dict, torch dict)."""
    tree = jax.tree.map(lambda a: np.asarray(a)[k], params["segments"][seg]["p0"]["attn"])
    return ({n: jnp.asarray(a) for n, a in tree.items()},
            {n: tensor_from_numpy(a) for n, a in tree.items()})


def _x(seed, shape, dtype):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _cache_leaves(cache):
    return {(seg, pj, n): t for seg, ps in cache["segments"].items()
            for pj, leaves in ps.items() for n, t in leaves.items()}


# --------------------------------------------------------------------------- #
# MLA layer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestMLA:
    def test_latent_and_queries(self, weights, dtype):
        jcfg, cfg, params = weights["deepseek-v2-lite-16b", dtype]
        jp, tp = _layer(params, "moe")
        jx, tx = _x(0, (2, 11, cfg.d_model), dtype)
        pos = np.stack([np.arange(11), np.arange(5, 16)])
        jc, jr = jax_layers._mla_latent(jp, jcfg, jx, jnp.asarray(pos))
        tc, tr = layers._mla_latent(tp, cfg, tx, torch.from_numpy(pos))
        _close(tc, jc, dtype)
        _close(tr, jr, dtype)
        jn, jq = jax_layers._mla_queries(jp, jcfg, jx, jnp.asarray(pos))
        tn, tq = layers._mla_queries(tp, cfg, tx, torch.from_numpy(pos))
        _close(tn, jn, dtype)
        _close(tq, jq, dtype)

    def test_full(self, weights, dtype):
        jcfg, cfg, params = weights["deepseek-v2-lite-16b", dtype]
        jp, tp = _layer(params, "lead")
        jx, tx = _x(1, (2, 37, cfg.d_model), dtype)
        _close(layers.mla_attention_full(tp, cfg, tx),
               jax_layers.mla_attention_full(jp, jcfg, jx), dtype)

    def test_prefill_writes_the_cache(self, weights, dtype):
        jcfg, cfg, params = weights["deepseek-v2-lite-16b", dtype]
        jp, tp = _layer(params, "moe")
        jx, tx = _x(2, (2, 13, cfg.d_model), dtype)
        m = cfg.mla
        jcache = {"c_kv": jnp.zeros((2, 32, m.kv_lora_rank), jnp.bfloat16),
                  "k_rope": jnp.zeros((2, 32, m.rope_head_dim), jnp.bfloat16)}
        tcache = {n: torch.zeros(a.shape, dtype=torch.bfloat16) for n, a in jcache.items()}
        ref, jcache = jax_layers.mla_attention_prefill(jp, jcfg, jx, jcache)
        out, tcache = layers.mla_attention_prefill(tp, cfg, tx, tcache)
        _close(out, ref, dtype)
        for n in ("c_kv", "k_rope"):
            _cache_close(tcache[n], jcache[n], dtype)
            assert not tcache[n][:, 13:].any()

    @pytest.mark.parametrize("pos", [[12, 5, 30], 9])
    def test_decode_per_slot_positions(self, weights, dtype, pos):
        """Absorbed decode on the same (reference-prefilled) cache, with a
        ragged per-slot position vector (30 is the cache's last entry) or a
        scalar one."""
        jcfg, cfg, params = weights["deepseek-v2-lite-16b", dtype]
        jp, tp = _layer(params, "moe")
        jx, tx = _x(3, (3, 12, cfg.d_model), dtype)
        m = cfg.mla
        jcache = {"c_kv": jnp.zeros((3, 31, m.kv_lora_rank), jnp.bfloat16),
                  "k_rope": jnp.zeros((3, 31, m.rope_head_dim), jnp.bfloat16)}
        _, jcache = jax_layers.mla_attention_prefill(jp, jcfg, jx, jcache)
        tcache = {n: tensor_from_numpy(np.asarray(a)) for n, a in jcache.items()}
        jstep, tstep = _x(4, (3, 1, cfg.d_model), dtype)
        ref, jcache = jax_layers.mla_attention_decode(jp, jcfg, jstep, jcache, jnp.asarray(pos))
        out, tcache = layers.mla_attention_decode(tp, cfg, tstep, tcache, torch.tensor(pos))
        _close(out, ref, dtype)
        for n in ("c_kv", "k_rope"):
            _cache_close(tcache[n], jcache[n], dtype)


@pytest.mark.parametrize("Sq,Sk,D,Dv,causal", [(37, 37, 24, 16, True), (20, 33, 192, 128, True),
                                               (33, 20, 40, 8, False), (64, 64, 192, 128, False)])
def test_flash_ref_value_head_dim_matches_chunked_attention(Sq, Sk, D, Dv, causal):
    """The plain flash version with Dv != D (the CPU route of MLA's prefill)
    against the reference model's ``chunked_attention``, f32, at MLA's scale
    and the default one."""
    rng = np.random.default_rng(Sq + D)
    q, k = (rng.standard_normal((2, s, 1, D)).astype(np.float32) for s in (Sq, Sk))
    v = rng.standard_normal((2, Sk, 1, Dv)).astype(np.float32)
    for scale in (None, 0.1):
        ref = jax_layers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=causal, q_chunk=16, q_offset=Sk - Sq,
                                           scale=scale)
        t = [torch.from_numpy(a[:, :, 0]) for a in (q, k, v)]
        out = flash_attention_ref(*t, causal=causal, scale=scale)
        assert out.shape == (2, Sq, Dv)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :, 0], atol=3e-5, rtol=1e-3)


def test_gqa_wrapper_takes_a_value_head_dim_and_scale():
    """``ops.gqa_flash_attention`` pads S and flattens heads for Dv != D as
    for the dense path, and passes the scale on."""
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((2, 45, 4, 24)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 45, 4, 16)).astype(np.float32)
    ref = jax_layers.chunked_attention(*map(jnp.asarray, (q, k, v)), causal=True, q_chunk=16,
                                       scale=24 ** -0.5 / 2)
    out = gqa_flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, block_q=32,
                              block_k=32, scale=24 ** -0.5 / 2)
    assert out.shape == (2, 45, 4, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-3)


# --------------------------------------------------------------------------- #
# whole models
# --------------------------------------------------------------------------- #
def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch,dtype", MODELS)
class TestModel:
    def test_forward_train(self, weights, arch, dtype, impl):
        """45 tokens: two router chunks of 32, the second padded."""
        jcfg, cfg, params = weights[arch, dtype]
        toks = _tokens(0, (2, 45), cfg.vocab)
        ref = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, moe_impl=impl)
        out = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)}, moe_impl=impl)
        assert out.dtype == getattr(torch, dtype)
        _close(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, arch, dtype, impl):
        jcfg, cfg, params = weights[arch, dtype]
        toks = _tokens(1, (2, 13), cfg.vocab)
        ref, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 32), moe_impl=impl)
        out, cache = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)},
                             mode="prefill", cache=init_cache(cfg, 2, 32, device="cpu"),
                             moe_impl=impl)
        _close(out, ref, dtype)
        leaves, jleaves = _cache_leaves(cache), _cache_leaves(jcache)
        assert set(leaves) == set(jleaves)
        for key, t in leaves.items():
            _cache_close(t, jleaves[key], dtype)
        assert int(cache["pos"]) == int(jcache["pos"]) == 13

    def test_decode_step_per_slot_positions(self, weights, arch, dtype, impl):
        """One decode tick with a ragged per-slot position vector, on the same
        (reference-prefilled) cache for both."""
        jcfg, cfg, params = weights[arch, dtype]
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
            _cache_close(t, jleaves[key], dtype)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_segments_and_layer_plan(arch):
    """The structural plan equals the reference's; layer i of a segment is
    p<j>[k] with i = the segment's offset + k·P + j."""
    cfg = get_config(arch)
    assert segments(cfg) == jax_T.segments(jax_get_config(arch))
    plan = layer_plan(cfg)
    assert len(plan) == cfg.n_layers
    i = 0
    for seg in segments(cfg):
        P = len(seg["pattern"])
        for slot in plan[i:i + seg["repeat"] * P]:
            assert slot.segment == seg["name"]
            assert (slot.mixer, slot.ffn) == seg["pattern"][slot.j]
        assert [s.k * P + s.j for s in plan[i:i + seg["repeat"] * P]] == list(
            range(seg["repeat"] * P))
        i += seg["repeat"] * P
    if arch.startswith("deepseek"):
        assert [(s.segment, s.ffn) for s in plan[:2]] == [("lead", "dense"), ("moe", "moe")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_params_from_numpy_unstacks_every_segment(weights, arch, dtype):
    """Every leaf of every segment and position lands in its layer: layer i
    holds ``segments/<name>/p<j>[k]``; the router stays f32 in a bf16 model,
    and a bf16 router is refused."""
    _, cfg, params = weights[arch, dtype]
    tree = jax.tree.map(np.asarray, params)
    model = params_from_numpy(cfg, tree, device="cpu")
    n_leaves = 0
    for name, prm in model.named_parameters():
        parts = name.split(".")
        if parts[0] != "layers":
            continue
        slot = model.plan[int(parts[1])]
        node = tree["segments"][slot.segment][f"p{slot.j}"]
        for key in parts[2:]:
            node = node[key]
        np.testing.assert_array_equal(_f32(prm), np.asarray(node, np.float32)[slot.k])
        want = torch.float32 if parts[-1] == "router" else getattr(torch, dtype)
        assert prm.dtype == want, name
        n_leaves += 1
    assert n_leaves == sum(np.asarray(a).shape[0] for a in
                           jax.tree.leaves(params["segments"]))
    if dtype == "bfloat16":
        seg = "moe"
        tree["segments"][seg]["p0"]["moe"]["router"] = (
            tree["segments"][seg]["p0"]["moe"]["router"].astype(jnp.bfloat16))
        with pytest.raises(ValueError, match="router"):
            params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "arctic-480b"])
def test_init_params_follows_param_defs(arch):
    """``init_params`` gives the reference's shapes, dtypes and
    initializers over ``lead``/``moe``: ones for norms and ``kv_norm``, an
    f32 router, normals at ``default_scale`` (``shape[-2]`` as the fan-in,
    the head count for MLA's ``wq``, ``w_uk`` and ``w_uv``)."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax_T.abstract_params(jax_get_config(arch).reduced())
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref)
    ported = params_from_numpy(cfg, tree, device="cpu")  # same leaves, shapes and dtypes
    assert [n for n, _ in ported.named_parameters()] == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf == "router" else torch.bfloat16), name
        if leaf in ("scale", "kv_norm"):
            assert bool((p == 1).all()), name
        else:
            want = 0.02 if leaf == "embed" else p.shape[-2] ** -0.5
            assert abs(float(p.float().std()) / want - 1) < 0.15, name
    if cfg.mla is not None:
        assert model.layers[0].attn["wq"].shape[-2] == cfg.n_heads
