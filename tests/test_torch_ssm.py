"""The port's mamba2 (SSM) mixer, model and engine against the JAX package's.

Both packages get the same weights: the reference's ``init_params`` tree for
the reduced ``mamba2-370m``, handed over as numpy through
``params_from_numpy``.  The port's full and prefill mixers run the SSD scan
through ``ops.ssd_mixer`` (on the CPU its plain version, the exact
sequential recurrence), where the reference's run ``_ssd_chunked``; decode
is the same one-token recurrence in both.

Tolerances:
* mixer outputs and logits, relative to their largest magnitude: f32 1e-4,
  bf16 5e-2 (``tests/test_torch_serve.py``'s logit tolerances).  In f32 the
  two differ in summation order and in the scan's form (sequential against
  chunked: measured up to 3.5e-7 of the logits' magnitude); in bf16 also in
  where matmul outputs and the scan's y are rounded to bf16.
* the cache's f32 state in f32 runs: atol 1e-4 + rtol 1e-4 (summation order).
  The conv window holds inputs of the mixer's convolution, rounded alike in
  both: rtol 1e-5 in f32, and in bf16 rtol 2**-7 (one bf16 ulp) for one
  mixer; in a bf16 model the cache takes the logits' tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_T
from repro.serve import Engine as JaxEngine, ServeConfig as JaxServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import SSD_LIBRARY, select_ssd_variant, ssd_mixer
from repro_torch.kernels.ssd_scan import wgmma_operands
from repro_torch.models import decode_step, forward, init_cache, init_params, ssm
from repro_torch.serve import Engine, ServeConfig

ARCH = "mamba2-370m"
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
PROMPTS = [[1, 2, 3], [9, 8, 7, 6], [4, 4], [5, 1, 2, 3, 4]]  # test_train_serve_elastic.py:74


@pytest.fixture(scope="module")
def weights():
    """(reference config, port config, reference params) per dtype."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jax_T.init_params(jcfg, jax.random.PRNGKey(0))
    return {"bfloat16": (jcfg, get_config(ARCH).reduced(), params),
            "float32": (jcfg, get_config(ARCH).reduced(),
                        jax.tree.map(lambda a: a.astype(jnp.float32), params))}


def _port(cfg, params):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, params), device="cpu")


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_rel(out, ref, dtype):
    out, ref = _f32(out), _f32(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL[dtype] * np.abs(ref).max())


def _assert_ssm_cache(tcache, jcache, dtype, one_layer=False):
    """conv window and f32 state, each in the reference's dtype.  Past the
    first layer of a bf16 model the layers' inputs already differ as the
    logits do, so the cache takes the logits' tolerance."""
    for name in ("conv", "ssd"):
        t, j = tcache[name], jcache[name]
        assert t.dtype == getattr(torch, str(j.dtype)), (name, t.dtype, j.dtype)
        if name == "conv" and (one_layer or dtype == "float32"):
            rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-5
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=rtol, atol=1e-6)
        elif dtype == "float32":
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-4, atol=1e-4)
        else:
            _assert_rel(t, j, dtype)


def _layer0(params):
    """The first layer's mixer parameters from the stacked reference tree."""
    return jax.tree.map(lambda a: a[0], params["segments"]["ssm"]["p0"]["ssm"])


def _both(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype)), torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestMixer:
    def test_full_and_prefill(self, weights, dtype):
        jcfg, cfg, params = weights[dtype]
        jp = _layer0(params)
        tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
        jx, tx = _both(np.random.default_rng(0).standard_normal((2, 21, cfg.d_model))
                       .astype(np.float32), dtype)
        ref_full, _ = jax_ssm.ssm_block(jp, jcfg, jx, mode="full")
        out_full, _ = ssm.ssm_block(tp, cfg, tx, mode="full")
        assert out_full.dtype == getattr(torch, dtype)
        _assert_rel(out_full, ref_full, dtype)
        ref, jcache = jax_ssm.ssm_block(jp, jcfg, jx, mode="prefill")
        defs = ssm.ssm_cache_defs(cfg, 2)
        cache = {"conv": torch.zeros(defs["conv"].shape, dtype=getattr(torch, dtype)),
                 "ssd": torch.zeros(defs["ssd"].shape, dtype=defs["ssd"].dtype)}
        out, cache = ssm.ssm_block(tp, cfg, tx, cache, mode="prefill")
        _assert_rel(out, ref, dtype)
        _assert_ssm_cache(cache, jcache, dtype, one_layer=True)

    def test_decode(self, weights, dtype):
        jcfg, cfg, params = weights[dtype]
        jp = _layer0(params)
        tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
        rng = np.random.default_rng(1)
        cs, ss = (d.shape for d in ssm.ssm_cache_defs(cfg, 3).values())
        conv = rng.standard_normal(cs).astype(np.float32)
        state = rng.standard_normal(ss).astype(np.float32)
        jx, tx = _both(rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32), dtype)
        jconv, tconv = _both(conv, dtype)
        ref, jcache = jax_ssm.ssm_block(jp, jcfg, jx, {"conv": jconv, "ssd": jnp.asarray(state)},
                                        mode="decode")
        cache = {"conv": tconv, "ssd": torch.from_numpy(state.copy())}
        out, cache = ssm.ssm_block(tp, cfg, tx, cache, mode="decode")
        _assert_rel(out, ref, dtype)
        _assert_ssm_cache(cache, jcache, dtype, one_layer=True)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
class TestModelParity:
    def test_forward_train(self, weights, dtype):
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(0, (2, 40), cfg.vocab)  # S = 40: no multiple of the reference's chunk (16)
        ref = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="train")
        out = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)}, mode="train")
        assert out.shape == (2, 40, cfg.vocab) and out.dtype == getattr(torch, dtype)
        _assert_rel(out, ref, dtype)

    def test_prefill_logits_and_cache(self, weights, dtype):
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(1, (2, 13), cfg.vocab)
        ref, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                    cache=jax_T.init_cache(jcfg, 2, 32))
        out, cache = forward(_port(cfg, params), cfg, {"tokens": torch.from_numpy(toks)},
                             mode="prefill",
                             cache=init_cache(cfg, 2, 32, device="cpu", dtype=getattr(torch, dtype)))
        _assert_rel(out, ref, dtype)
        _assert_ssm_cache(cache["segments"]["ssm"]["p0"], jcache["segments"]["ssm"]["p0"], dtype)
        assert int(cache["pos"]) == int(jcache["pos"]) == 13

    def test_decode_step(self, weights, dtype):
        """One decode tick on the same (reference-prefilled) cache for both."""
        jcfg, cfg, params = weights[dtype]
        toks = _tokens(2, (3, 12), cfg.vocab)
        _, jcache = jax_T.forward(params, jcfg, {"tokens": jnp.asarray(toks)}, mode="prefill",
                                  cache=jax_T.init_cache(jcfg, 3, 32))
        cache = {"segments": {"ssm": {"p0": {
            n: tensor_from_numpy(np.asarray(v))
            for n, v in jcache["segments"]["ssm"]["p0"].items()}}}}
        pos = np.array([12, 7, 10])
        jcache["pos"], cache["pos"] = jnp.asarray(pos, jnp.int32), torch.from_numpy(pos)
        step = _tokens(3, (3, 1), cfg.vocab)
        ref, jcache = jax_T.decode_step(params, jcfg, jcache, jnp.asarray(step))
        out, cache = decode_step(_port(cfg, params), cfg, cache, torch.from_numpy(step))
        _assert_rel(out, ref, dtype)
        _assert_ssm_cache(cache["segments"]["ssm"]["p0"], jcache["segments"]["ssm"]["p0"], dtype)
        np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(jcache["pos"]))


class TestEngine:
    def test_tokens_and_cache_equal_jax_engine(self, weights):
        """f32 weights: the port's engine emits exactly the reference engine's
        tokens, and its slot pool ends equal to the reference's: the conv
        window in the dtype the reference's steps leave it in (f32 once a
        decode tick has run), the state in f32."""
        jcfg, cfg, params = weights["float32"]
        jeng = JaxEngine(jcfg, params, JaxServeConfig(max_seq=64, slots=3))
        jreqs = [jeng.submit(p, max_new=5) for p in PROMPTS]
        jeng.run_until_done()
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=3), device="cpu")
        reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
        eng.run_until_done()
        assert [r.out for r in reqs] == [r.out for r in jreqs]
        _assert_ssm_cache(eng.cache["segments"]["ssm"]["p0"],
                          jeng.cache["segments"]["ssm"]["p0"], "float32")
        assert eng.cache["segments"]["ssm"]["p0"]["conv"].dtype == torch.float32

    def test_engine_matches_teacher_forced(self, weights):
        """bf16 weights: engine tokens == teacher-forced greedy decoding."""
        _, cfg, params = weights["bfloat16"]
        model = _port(cfg, params)
        eng = Engine(cfg, model, ServeConfig(max_seq=64, slots=3), device="cpu")
        reqs = [eng.submit(p, max_new=5) for p in PROMPTS]
        eng.run_until_done()
        for r, p in zip(reqs, PROMPTS):
            toks, ref = list(p), []
            for _ in range(5):
                lg = forward(model, cfg, {"tokens": torch.tensor(toks)[None]}, mode="train")
                ref.append(int(torch.argmax(lg[0, -1])))
                toks.append(ref[-1])
            assert r.out == ref, (r.out, ref)

    def test_cpu_route_launches_nothing(self, weights):
        _, cfg, params = weights["bfloat16"]
        before = SSD_LIBRARY.launches
        eng = Engine(cfg, _port(cfg, params), ServeConfig(max_seq=64, slots=2), device="cpu")
        eng.submit([1, 2, 3], max_new=3)
        eng.run_until_done()
        assert SSD_LIBRARY.launches == before


def test_init_params_follows_param_defs():
    """``init_params`` gives the reference's shapes, dtypes and initializers
    for the SSM leaves: f32 ``dt_bias``/``A_log``/``Dskip`` in a bf16 model,
    zeros and ones where ``ParamDef`` says so, ``conv_w`` at 1/conv_width."""
    cfg = get_config(ARCH).reduced()
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = jax_T.abstract_params(jax_get_config(ARCH).reduced())
    port = params_from_numpy(  # every port leaf exists, with the reference's shape and dtype
        cfg, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), ref), device="cpu")
    for (name, p), (_, q) in zip(model.named_parameters(), port.named_parameters()):
        assert p.dtype == q.dtype and p.shape == q.shape and not p.requires_grad, name
        leaf = name.rsplit(".", 1)[-1]
        assert p.dtype == (torch.float32 if leaf in ("dt_bias", "A_log", "Dskip")
                           else torch.bfloat16), name
        if leaf in ("scale", "Dskip", "norm"):
            assert bool((p == 1).all()), name
        elif leaf in ("dt_bias", "A_log", "conv_b"):
            assert bool((p == 0).all()), name
        else:
            want = {"embed": 0.02, "conv_w": 1 / cfg.ssm.conv_width}.get(leaf, p.shape[-2] ** -0.5)
            assert abs(float(p.float().std()) / want - 1) < 0.15, name


def test_cache_follows_reference_defs():
    cfg = get_config(ARCH).reduced()
    cache = init_cache(cfg, 3, 32, device="cpu")
    ref = jax_T.init_cache(jax_get_config(ARCH).reduced(), 3, 32)
    for n, j in ref["segments"]["ssm"]["p0"].items():
        t = cache["segments"]["ssm"]["p0"][n]
        assert tuple(t.shape) == j.shape and t.dtype == getattr(torch, str(j.dtype)), n
        assert not bool(t.any())


def test_mixer_on_strided_group_views_equals_repeated_copies():
    """``ssd_mixer`` on the views ``ssm._split`` slices from the conv output
    (row stride d_in + 2GN, one group for all heads) equals ``ssd_mixer`` on
    contiguous copies with the group repeated to every head."""
    cfg = get_config(ARCH).reduced()
    d_in, H, P, N, G = ssm.ssm_dims(cfg)
    assert G < H
    rng = np.random.default_rng(5)
    conv_out = torch.from_numpy(rng.standard_normal((2, 19, d_in + 2 * G * N))
                                .astype(np.float32) * 0.5)
    xh, Bm, Cm = ssm._split(cfg, conv_out)
    assert not xh.is_contiguous() and xh.data_ptr() == conv_out.data_ptr()
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((2, 19, H))).astype(np.float32))
    A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32))
    y, h = ssd_mixer(xh, dt, A, Bm, Cm, return_state=True)
    ry, rh = ssd_mixer(xh.contiguous(), dt, A, Bm.repeat_interleave(H // G, dim=2).contiguous(),
                       Cm.repeat_interleave(H // G, dim=2).contiguous(), return_state=True)
    torch.testing.assert_close(y, ry, atol=0, rtol=0)
    torch.testing.assert_close(h, rh, atol=0, rtol=0)


def test_prefill_hands_the_scan_conv_views_uncopied(monkeypatch):
    """At mamba2-370m's full widths (bf16), the prefill mixer passes x, B and
    C to the scan as views of its conv output and dt, A as they come: the
    ``wgmma`` kernel takes them, and its operands are those very views (no
    ``repeat_interleave``, no ``.contiguous()`` copy)."""
    cfg = get_config(ARCH)
    d_in, H, P, N, G = ssm.ssm_dims(cfg)
    assert select_ssd_variant(P, N, torch.bfloat16) == "wgmma"
    g = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(d.shape, generator=g) * 0.02).to(d.dtype)
         for k, d in ssm.ssm_defs(cfg).items()}
    seen = {}

    def spy(x, dt, A, Bm, Cm, return_state=False):
        seen.update(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
        return ssd_mixer(x, dt, A, Bm, Cm, return_state=return_state)

    monkeypatch.setattr(ssm, "ssd_mixer", spy)
    S = 5
    cache = {n: torch.zeros(d.shape, dtype=d.dtype) for n, d in ssm.ssm_cache_defs(cfg, 1).items()}
    ssm.ssm_block(p, cfg, torch.randn(1, S, cfg.d_model, generator=g).to(torch.bfloat16), cache,
                  mode="prefill")
    x, dt, A, Bm, Cm = (seen[k] for k in ("x", "dt", "A", "Bm", "Cm"))
    row = d_in + 2 * G * N
    assert x.stride() == (S * row, row, P, 1) and Bm.stride() == Cm.stride() == (S * row, row, N, 1)
    assert Bm.data_ptr() - x.data_ptr() == 2 * d_in and Cm.data_ptr() - Bm.data_ptr() == 2 * G * N
    assert dt.dtype == A.dtype == torch.float32 and dt.is_contiguous()
    A2 = A[None].expand(1, H)
    ox, odt, oA, oB, oC, strides = wgmma_operands(x, dt, A2, Bm, Cm)
    for a, b in ((ox, x), (odt, dt), (oA, A2), (oB, Bm), (oC, Cm)):
        assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
    assert strides == [S * row, row, P, S * H, H, 1, *A2.stride(), S * row, row, N,
                       S * H * P, H * P, P]


def test_views_tma_cannot_take_are_copied():
    """A view whose start or strides are not on 16 bytes is copied (made
    contiguous) before the kernel reads it; the others stay views."""
    buf = torch.zeros(1, 8, 2 * 64 + 2 * 16 + 1, dtype=torch.bfloat16)
    x = buf[..., :128].reshape(1, 8, 2, 64)            # row stride of 161 elements
    Bm = buf[..., 129:145].reshape(1, 8, 1, 16)         # odd start
    dt, A2 = torch.zeros(1, 8, 2), torch.zeros(1, 2)
    ox, _, _, oB, oC, _ = wgmma_operands(x, dt, A2, Bm, Bm)
    assert ox.is_contiguous() and ox.data_ptr() != x.data_ptr()
    assert oB.is_contiguous() and oC.is_contiguous()
    good = torch.zeros(1, 8, 128, dtype=torch.bfloat16).reshape(1, 8, 2, 64)
    assert wgmma_operands(good, dt, A2, good[..., :16], good[..., 16:32])[0] is good
