"""The frontends (HuBERT's frame embeddings, LLaVA's image embeddings) and
the non-causal encoder in the port against the JAX package's.

Both packages get the same weights: the reference's ``init_params`` tree for
the reduced ``hubert-xlarge`` (2 bidirectional layers, no rope, frames only)
and ``llava-next-mistral-7b`` (a Mistral backbone that takes image
embeddings ahead of the text tokens), handed over as numpy through
``params_from_numpy``; embeddings and tokens are drawn with numpy from a
seed and fed to both.

Tolerances, on outputs relative to their largest magnitude, as
``tests/test_torch_serve.py`` sets them: f32 1e-4 (summation order; the
port's flash route against the reference's ``chunked_attention``), bf16 5e-2
(the reference rounds the gate/up products and the attention probabilities
to bf16, the kernels' plain versions do not).  Cache entries are bf16 in
both: within 2 bf16 ulps in f32 runs, within the outputs' tolerance in bf16.

The f32 runs take the reference's weights as drawn.  The bf16 runs take
them with ``wq``/``wk``/``wv`` rescaled to the fan-in d_model, as
``chip_smoke.py`` does (ROADMAP Queue 3: ``default_scale`` takes the head
count as their fan-in): as drawn, the scores are ~16 times too large, the
softmax a near argmax, and the reference's own bf16 logits sit 0.12-0.28
of the largest from its f32 ones (the port's likewise), so two bf16 runs
differ by up to 0.068 of rounding alone; rescaled, 0.010-0.014 (measured,
seeds 0-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.models import frontends as jax_frontends
from repro.models import layers as jax_layers
from repro.models import transformer as jax_T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import gqa_flash_attention
from repro_torch.models import (
    VLM_IMAGE_TOKENS, decode_step, forward, frontend_token_split, init_cache, input_structs,
    layers, synth_inputs,
)

HUBERT, LLAVA = "hubert-xlarge", "llava-next-mistral-7b"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _rescaled(params, d_model):
    """q/k/v of every layer scaled from fan-in H to fan-in d_model."""
    params = jax.tree.map(lambda a: a, params)  # new containers, the same leaves
    attn = params["segments"]["dense"]["p0"]["attn"]
    for n in ("wq", "wk", "wv"):
        w = attn[n]  # [L, d, H, Dh]
        attn[n] = (w.astype(jnp.float32) * (w.shape[2] / d_model) ** 0.5).astype(w.dtype)
    return params


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per (arch, dtype):
    bf16 with q/k/v rescaled, f32 as drawn."""
    out = {}
    for arch in (HUBERT, LLAVA):
        jcfg = jax_get_config(arch).reduced()
        params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
        cfg = get_config(arch).reduced()
        out[arch, "bfloat16"] = (jcfg, cfg, _rescaled(params, cfg.d_model))
        out[arch, "float32"] = (jcfg, cfg, jax.tree.map(lambda a: a.astype(jnp.float32), params))
    return out


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _err(out, ref):
    """Largest difference relative to the reference's largest magnitude."""
    out, ref = _f32(out), _f32(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _close(out, ref, dtype):
    assert _err(out, ref) <= TOL[dtype]


def _embeds(seed, shape, dtype, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


def _inputs(cfg, seed, batch, n_emb, n_txt, dtype):
    """The same embeds (normals at 0.02, as ``synth_inputs`` draws them) and
    tokens for both packages: (reference inputs, port inputs)."""
    jin, tin = {}, {}
    if n_emb:
        jin["embeds"], tin["embeds"] = _embeds(seed, (batch, n_emb, cfg.d_model), dtype, 0.02)
    if n_txt:
        toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (batch, n_txt))
        jin["tokens"], tin["tokens"] = jnp.asarray(toks), torch.from_numpy(toks)
    return jin, tin


def _attn(params, k=0):
    """Layer k's attention leaves: (jax dict, torch dict)."""
    tree = jax.tree.map(lambda a: np.asarray(a)[k], params["segments"]["dense"]["p0"]["attn"])
    return ({n: jnp.asarray(a) for n, a in tree.items()},
            {n: tensor_from_numpy(a) for n, a in tree.items()})


# --------------------------------------------------------------------------- #
# the non-causal repair
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 64])
def test_encoder_attention_attends_both_ways(weights, dtype, S):
    """HuBERT's attention (``attention_full`` and ``attention_prefill``)
    against the reference's, S ragged and not.  The route the port took
    before, ``gqa_flash_attention`` (causal whatever it is given, as the
    reference's wrapper is), is the planted fault: it reads more than half
    of the reference's largest output, far above the tolerance."""
    jcfg, cfg, params = weights[HUBERT, dtype]
    assert not cfg.causal and cfg.rope_theta is None
    jp, tp = _attn(params)
    jx, tx = _embeds(S, (2, S, cfg.d_model), dtype)
    ref = jax_layers.attention_full(jp, jcfg, jx)
    _close(layers.attention_full(tp, cfg, tx), ref, dtype)
    cache = {n: torch.zeros((2, 80, cfg.n_kv_heads, cfg.head_dim), dtype=torch.bfloat16)
             for n in ("k", "v")}
    jcache = {n: jnp.zeros((2, 80, cfg.n_kv_heads, cfg.head_dim), jnp.bfloat16)
              for n in ("k", "v")}
    jout, jcache = jax_layers.attention_prefill(jp, jcfg, jx, jcache)
    out, cache = layers.attention_prefill(tp, cfg, tx, cache)
    _close(out, jout, dtype)
    for n in ("k", "v"):
        np.testing.assert_allclose(_f32(cache[n]), _f32(jcache[n]), rtol=2.0 ** -6, atol=1e-3)
    q, k, v = layers.attention_qkv(tp, cfg, tx, layers._prompt_positions(tx))
    causal_route = layers._out_proj(tp, gqa_flash_attention(q, k, v, causal=cfg.causal))
    assert _err(causal_route, ref) > 0.5


def test_bidirectional_entry_matches_chunked_attention():
    """The non-causal entry (GQA, S = 45: no block multiple) against the
    reference model's non-causal ``chunked_attention``, and exactly the
    plain non-causal attention on the unpadded operands.  The repair leaves
    ``gqa_flash_attention`` as the reference's wrapper (causal whatever it
    is given; ``tests/test_torch_kernels.py`` pins that)."""
    from repro_torch.kernels import gqa_bidirectional_attention
    from repro_torch.kernels.ref import flash_attention_ref

    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 45, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((2, 45, 2, 16)).astype(np.float32))
            for _ in range(2))
    ref = jax_layers.chunked_attention(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                                       causal=False, q_chunk=16)
    out = gqa_bidirectional_attention(q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-3)
    flat = [t.repeat_interleave(4 // t.shape[2], dim=2).movedim(2, 1).reshape(8, 45, 16)
            for t in (q, k, v)]
    plain = flash_attention_ref(*flat, causal=False).reshape(2, 4, 45, 16).movedim(1, 2)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


# --------------------------------------------------------------------------- #
# HuBERT: the encoder over frame embeddings
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestHubert:
    def test_forward_train(self, weights, dtype):
        jcfg, cfg, params = weights[HUBERT, dtype]
        jin, tin = _inputs(cfg, 0, 2, 45, 0, dtype)
        ref = jax_T.forward(params, jcfg, jin, mode="train")
        out = forward(_port(cfg, params), cfg, tin, mode="train")
        assert out.shape == (2, 45, cfg.vocab) and out.dtype == getattr(torch, dtype)
        _close(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, dtype):
        jcfg, cfg, params = weights[HUBERT, dtype]
        jin, tin = _inputs(cfg, 1, 2, 30, 0, dtype)
        ref, jcache = jax_T.forward(params, jcfg, jin, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 30))
        out, cache = forward(_port(cfg, params), cfg, tin, mode="prefill",
                             cache=init_cache(cfg, 2, 30, device="cpu"))
        _close(out, ref, dtype)
        for n in ("k", "v"):
            t, j = cache["segments"]["dense"]["p0"][n], jcache["segments"]["dense"]["p0"][n]
            assert t.dtype == torch.bfloat16
            if dtype == "float32":
                np.testing.assert_allclose(_f32(t), _f32(j), rtol=2.0 ** -6, atol=1e-3)
            else:
                _close(t, j, dtype)
        assert int(cache["pos"]) == int(jcache["pos"]) == 30

    def test_first_frame_sees_the_last(self, weights, dtype):
        """Bidirectional: changing the last frame moves the first frame's
        logits, by as much in the port as in the reference."""
        jcfg, cfg, params = weights[HUBERT, dtype]
        model = _port(cfg, params)
        jin, tin = _inputs(cfg, 2, 1, 20, 0, dtype)
        moved = {}
        for name, fwd, inp in (("ref", lambda i: jax_T.forward(params, jcfg, i), jin),
                               ("port", lambda i: forward(model, cfg, i), tin)):
            base = _f32(fwd(inp))[0, 0]
            e = inp["embeds"]
            bumped = e.at[:, -1].add(1.0) if name == "ref" else torch.cat(
                [e[:, :-1], e[:, -1:] + 1.0], dim=1)
            moved[name] = float(np.abs(_f32(fwd({"embeds": bumped}))[0, 0] - base).max())
        assert moved["port"] > 1e-2 and moved["ref"] > 1e-2
        assert abs(moved["port"] - moved["ref"]) <= 0.2 * moved["ref"]


# --------------------------------------------------------------------------- #
# LLaVA: image embeddings ahead of the text
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestLlava:
    def test_forward_train(self, weights, dtype):
        """24 image rows then 21 text tokens (``frontend_token_split`` at 45)."""
        jcfg, cfg, params = weights[LLAVA, dtype]
        n_emb, n_txt = frontend_token_split(cfg, 45)
        jin, tin = _inputs(cfg, 3, 2, n_emb, n_txt, dtype)
        ref = jax_T.forward(params, jcfg, jin, mode="train")
        out = forward(_port(cfg, params), cfg, tin, mode="train")
        assert out.shape == (2, 45, cfg.vocab)
        _close(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, dtype):
        jcfg, cfg, params = weights[LLAVA, dtype]
        jin, tin = _inputs(cfg, 4, 2, 10, 7, dtype)
        ref, jcache = jax_T.forward(params, jcfg, jin, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 32))
        out, cache = forward(_port(cfg, params), cfg, tin, mode="prefill",
                             cache=init_cache(cfg, 2, 32, device="cpu"))
        _close(out, ref, dtype)
        for n in ("k", "v"):
            t, j = cache["segments"]["dense"]["p0"][n], jcache["segments"]["dense"]["p0"][n]
            if dtype == "float32":
                np.testing.assert_allclose(_f32(t), _f32(j), rtol=2.0 ** -6, atol=1e-3)
            else:
                _close(t, j, dtype)
        assert int(cache["pos"]) == int(jcache["pos"]) == 17

    def test_decode_matches_teacher_forcing(self, weights, dtype):
        """``tests/test_models_smoke.py::test_decode_matches_teacher_forcing``
        with an image: prefill 8 image rows and 4 text tokens, then decode
        the next 4 text tokens teacher-forced (the reference's tokens,
        ``jax.random.randint`` from its key).  Each step's logits equal the
        reference's decode steps, and the port's own train forward over the
        image and the text within 5e-2 of their largest in both dtypes: the
        decode reads k/v from the bf16 cache (so does the reference's, which
        in f32 sits 1e-2 from its own forward here), and in bf16 rounds the
        probabilities where the flash route keeps them f32."""
        jcfg, cfg, params = weights[LLAVA, dtype]
        toks = np.array(jax.random.randint(jax.random.PRNGKey(0), (2, 8), 0, cfg.vocab))
        jemb, temb = _embeds(5, (2, 8, cfg.d_model), dtype, 0.02)
        model = _port(cfg, params)
        t = torch.from_numpy(toks)
        full = forward(model, cfg, {"embeds": temb, "tokens": t}).float()
        _, cache = forward(model, cfg, {"embeds": temb, "tokens": t[:, :4]}, mode="prefill",
                           cache=init_cache(cfg, 2, 32, device="cpu"))
        _, jcache = jax_T.forward(params, jcfg, {"embeds": jemb, "tokens": jnp.asarray(toks[:, :4])},
                                  mode="prefill", cache=jax_T.init_cache(jcfg, 2, 32))
        for i in range(4, 8):
            lg, cache = decode_step(model, cfg, cache, t[:, i:i + 1])
            ref, jcache = jax_T.decode_step(params, jcfg, jcache, jnp.asarray(toks[:, i:i + 1]))
            _close(lg, ref, dtype)
            _close(lg[:, 0], full[:, 8 + i], "bfloat16")
        assert int(cache["pos"]) == 16


# --------------------------------------------------------------------------- #
# the frontend helpers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_frontend_token_split_equals_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for n in range(1, 2049):
        assert frontend_token_split(cfg, n) == jax_frontends.frontend_token_split(jcfg, n), n
    assert VLM_IMAGE_TOKENS == jax_frontends.VLM_IMAGE_TOKENS


@pytest.mark.parametrize("seq", [1, 7, 1152, 2000])
@pytest.mark.parametrize("arch", [HUBERT, LLAVA, "tinyllama-1.1b"])
def test_synth_inputs_and_input_structs_follow_reference(arch, seq):
    """The same keys, shapes and dtypes as the reference's ``synth_inputs``
    and ``input_structs`` (``meta`` tensors for ``ShapeDtypeStruct``s);
    embeddings at the reference's scale; tokens inside the vocabulary; the
    same generator seed gives the same inputs."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ref = jax_frontends.synth_inputs(jcfg, 2, seq)
    structs = jax_frontends.input_structs(jcfg, 2, seq)
    out = synth_inputs(cfg, 2, seq, torch.Generator().manual_seed(0), device="cpu")
    meta = input_structs(cfg, 2, seq)
    assert set(out) == set(ref) == set(meta) == set(structs)
    for name, t in out.items():
        assert tuple(t.shape) == ref[name].shape == tuple(meta[name].shape)
        assert t.dtype == meta[name].dtype == getattr(torch, str(structs[name].dtype))
        assert t.device.type == "cpu" and meta[name].device.type == "meta"
    if "embeds" in out and out["embeds"].numel() > 1000:
        assert abs(float(out["embeds"].float().std()) / 0.02 - 1) < 0.1
    if "tokens" in out:
        assert 0 <= int(out["tokens"].min()) and int(out["tokens"].max()) < cfg.vocab
    again = synth_inputs(cfg, 2, seq, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(out[n], again[n]) for n in out)
