"""The port's MoE layer, its two dispatches and the expert-batched SwiGLU,
and its serving engine on a MoE/MLA model, against the JAX package's.

The layer's weights are the reference's ``init_params`` leaves of one MoE
layer of the reduced ``deepseek-v2-lite-16b`` (64-wide, 4 experts top-2,
two shared experts) and ``arctic-480b`` (a dense residual), handed over as
numpy.  Inputs are drawn with numpy from a seed.

Tolerances, relative to the output's largest magnitude: f32 1e-4 (the two
differ in summation order only); bf16 5e-2, as ``tests/test_torch_serve.py``
sets it (the reference rounds the gate/up products, silu(g) and each
expert's output to bf16; the fused kernels round once).  Routing is exact in
f32 (the router is f32 in both packages, in a bf16 model too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import swiglu_matmul as jax_swiglu_matmul
from repro.models import layers as jax_layers
from repro.models import moe_scatter as jax_moe_scatter
from repro.models import transformer as jax_T
from repro.serve import Engine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import swiglu_experts
from repro_torch.kernels.ref import swiglu_experts_ref
from repro_torch.models import forward, init_cache, layers, moe_scatter
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import _splice_cache

TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ARCHS = ["deepseek-v2-lite-16b", "arctic-480b"]
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5, 1, 2, 3, 4]]  # test_train_serve_elastic.py:74


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per (arch, dtype)."""
    out = {}
    for arch in ARCHS:
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


def _moe(params, k=0):
    """MoE leaves of layer k of the ``moe`` segment: (jax tree, torch tree)."""
    tree = jax.tree.map(lambda a: np.asarray(a)[k], params["segments"]["moe"]["p0"]["moe"])
    return (jax.tree.map(jnp.asarray, tree), jax.tree.map(tensor_from_numpy, tree))


def _x(seed, shape, dtype, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _routed(jp, m, xc):
    """Tokens each expert is chosen by, per group, under the reference's routing."""
    gates = jax.nn.softmax(jnp.einsum("gsd,de->gse", xc.astype(jnp.float32), jp["router"]), -1)
    _, idx = jax.lax.top_k(gates, m.top_k)
    return np.stack([np.bincount(g.ravel(), minlength=m.n_experts) for g in np.asarray(idx)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
class TestChunk:
    def test_einsum_dispatch(self, weights, arch, dtype):
        jcfg, cfg, params = weights[arch, dtype]
        jp, tp = _moe(params)
        jx, tx = _x(0, (3, 32, cfg.d_model), dtype)
        ref = jax_layers._moe_chunk_einsum(jp, jcfg.moe, jx)
        _close(layers._moe_chunk_einsum(tp, cfg.moe, tx), ref, dtype)

    def test_scatter_dispatch(self, weights, arch, dtype):
        jcfg, cfg, params = weights[arch, dtype]
        jp, tp = _moe(params)
        jx, tx = _x(1, (3, 32, cfg.d_model), dtype)
        ref = jax_moe_scatter.moe_chunk_scatter(jp, jcfg.moe, jx)
        _close(moe_scatter.moe_chunk_scatter(tp, cfg.moe, tx), ref, dtype)

    @pytest.mark.parametrize("impl", ["einsum", "scatter"])
    def test_drops_under_a_biased_router(self, weights, arch, dtype, impl):
        """A router biased toward expert 0: every token picks it, its 20
        slots (capacity of 32 tokens, top-2 of 4, factor 1.25) overflow and
        the late tokens are dropped, as in the reference."""
        jcfg, cfg, params = weights[arch, dtype]
        jp, tp = _moe(params)
        jx, tx = _x(2, (2, 32, cfg.d_model), dtype)
        jx, tx = jx.at[..., 0].set(4.0), tx.clone()
        tx[..., 0] = 4.0
        jp = dict(jp, router=jp["router"].at[0, 0].set(10.0))
        tp = dict(tp, router=tp["router"].clone())
        tp["router"][0, 0] = 10.0
        C = layers.moe_capacity(cfg.moe, 32)
        assert (_routed(jp, jcfg.moe, jx)[:, 0] > C).all()  # drops happen in every group
        fn = {"einsum": (jax_layers._moe_chunk_einsum, layers._moe_chunk_einsum),
              "scatter": (jax_moe_scatter.moe_chunk_scatter, moe_scatter.moe_chunk_scatter)}[impl]
        ref = fn[0](jp, jcfg.moe, jx)
        _close(fn[1](tp, cfg.moe, tx), ref, dtype)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [20, 77])
def test_moe_layer(weights, arch, dtype, impl, S):
    """The whole layer: routed experts over chunks of 32 tokens (77: three
    chunks, the last one padded), plus the shared experts (deepseek) or the
    dense residual (arctic)."""
    jcfg, cfg, params = weights[arch, dtype]
    jp, tp = _moe(params)
    jx, tx = _x(3, (2, S, cfg.d_model), dtype)
    ref = jax_layers.moe_layer(jp, jcfg, jx, impl=impl)
    _close(layers.moe_layer(tp, cfg, tx, impl=impl), ref, dtype)


def test_moe_layer_refuses_an_unknown_impl(weights):
    _, cfg, params = weights["deepseek-v2-lite-16b", "float32"]
    with pytest.raises(ValueError, match="unknown moe impl"):
        layers.moe_layer(_moe(params)[1], cfg, torch.zeros(1, 4, cfg.d_model), impl="sort")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,M,D,F", [(4, 32, 64, 128), (3, 8, 128, 64), (1, 20, 64, 32)])
def test_experts_plain_version_matches_pallas_per_expert(dtype, E, M, D, F):
    """``swiglu_experts`` (its plain version on the CPU) against the
    reference's Pallas ``swiglu_matmul`` once per expert, in interpret mode;
    the tolerances of ``tests/test_kernels.py`` (f32 1e-4, bf16 5e-2, rtol
    2e-2)."""
    rng = np.random.default_rng(E * M)
    arrs = [(rng.standard_normal(s) * sc).astype(np.float32)
            for s, sc in (((E, M, D), 1.0), ((E, D, F), D ** -0.5), ((E, D, F), D ** -0.5))]
    jx, jg, ju = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    ref = np.stack([np.asarray(jax_swiglu_matmul(jx[e], jg[e], ju[e], block_m=min(M, 32),
                                                 block_f=min(F, 64), block_k=64,
                                                 interpret=True), np.float32)
                    for e in range(E)])
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    out = swiglu_experts(*t)
    assert out.shape == (E, M, F) and out.dtype == getattr(torch, dtype)
    torch.testing.assert_close(out, swiglu_experts_ref(*t), atol=0, rtol=0)
    np.testing.assert_allclose(_f32(out), ref, atol=1e-4 if dtype == "float32" else 5e-2,
                               rtol=2e-2)


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_jax_engine(weights, arch, impl):
    """f32 weights: the port's engine emits exactly the reference engine's
    tokens, with ``ServeConfig.moe_impl`` passed to both steps."""
    jcfg, cfg, params = weights[arch, "float32"]
    jeng = JaxEngine(jcfg, params, JaxServeConfig(max_seq=64, slots=3, moe_impl=impl))
    jreqs = [jeng.submit(p, max_new=5) for p in PROMPTS]
    jeng.run_until_done()
    eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=3, moe_impl=impl),
                 device="cpu")
    reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
    eng.run_until_done()
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_engine_matches_teacher_forced_decoding(weights):
    """bf16 weights, ``router_chunk = 1`` (every token its own group: no
    capacity drops in prefill, decode or the forward): engine tokens equal
    teacher-forced greedy decoding.

    As ``chip_smoke.py`` does, ``wq`` is rescaled to the fan-in d_model and
    ``w_uk``/``w_uv`` to the fan-in kv_lora_rank first: the reference's
    ``default_scale`` takes the head count as their fan-in (ROADMAP Queue 3),
    and with its scores a near tie flips the reference's own engine against
    its own teacher-forced decoding on the third prompt, in f32 and in bf16
    alike (the port's engine gives the reference engine's tokens there)."""
    _, cfg, params = weights["deepseek-v2-lite-16b", "bfloat16"]
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, router_chunk=1))
    model = _port(cfg, params)
    with torch.no_grad():
        for block in model.layers:
            block.attn["wq"].mul_((cfg.n_heads / cfg.d_model) ** 0.5)
            for name in ("w_uk", "w_uv"):
                block.attn[name].mul_((cfg.n_heads / cfg.mla.kv_lora_rank) ** 0.5)
    eng = Engine(cfg, model, ServeConfig(max_seq=64, slots=3), device="cpu")
    reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
    eng.run_until_done()
    for r, p in zip(reqs, PROMPTS):
        toks, ref = list(p), []
        for _ in range(5):
            t = int(torch.argmax(forward(model, cfg, {"tokens": torch.tensor(toks)[None]})[0, -1]))
            ref.append(t)
            toks.append(t)
        assert r.out == ref, (r.out, ref)


def test_serve_config_has_the_reference_fields():
    ours = {f.name: f.default for f in dataclasses.fields(ServeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxServeConfig)}
    assert ours["moe_impl"] == ref["moe_impl"] == "einsum"
    assert set(ours) <= set(ref)


def test_splice_cache_writes_the_latent_slot():
    """``_splice_cache`` writes a batch-1 MLA cache (``c_kv``, ``k_rope`` of
    the ``lead`` and ``moe`` segments) into one slot of the pool, leaves the
    other slots as they were, and keeps the pool's dtype."""
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    pool = init_cache(cfg, 3, 16, device="cpu")
    single = init_cache(cfg, 1, 16, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    for leaves in (l for ps in single["segments"].values() for l in ps.values()):
        for t in leaves.values():
            t.copy_(torch.randn(t.shape, generator=g))
    pool = _splice_cache(pool, single, 1)
    names = set()
    for seg, ps in pool["segments"].items():
        for pj, leaves in ps.items():
            for n, t in leaves.items():
                names.add((seg, n))
                assert t.dtype == torch.bfloat16
                src = single["segments"][seg][pj][n][:, 0]
                torch.testing.assert_close(t[:, 1], src.to(torch.bfloat16), atol=0, rtol=0)
                assert not t[:, 0].any() and not t[:, 2].any()
    assert names == {(s, n) for s in ("lead", "moe") for n in ("c_kv", "k_rope")}
