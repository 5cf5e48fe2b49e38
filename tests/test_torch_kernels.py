"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their kernels' plain PyTorch versions
(the CUDA kernels run only on the card, where ``chip_smoke.py`` and
``tests/test_torch_card.py`` hold them to the same plain versions); the JAX side
runs its Pallas kernels in interpret mode, as ``tests/test_kernels.py``
does.  Inputs are drawn with numpy from a seed and handed to both.
Tolerances are those of ``tests/test_kernels.py``: flash f32 atol 2e-5,
bf16 3e-2, rtol 1e-2; swiglu f32 1e-4, bf16 5e-2, rtol 2e-2; ssd_scan f32
2e-3·scale, bf16 0.15·scale with scale = max(|ref|, 1).
"""
import importlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro.kernels import fused_swiglu as jax_fused_swiglu
from repro.kernels import gqa_flash_attention as jax_gqa_flash_attention
from repro.kernels import ssd_mixer as jax_ssd_mixer
from repro.kernels import ssd_scan as jax_ssd_scan
from repro.kernels import swiglu_matmul as jax_swiglu_matmul
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro_torch.kernels import (
    FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, fused_swiglu,
    gqa_flash_attention, ssd_mixer, ssd_scan, swiglu_matmul,
)
from repro_torch.kernels.ref import (
    flash_attention_ref, ssd_scan_ref, ssd_scan_three_phase, swiglu_ref,
)
from repro_torch.models import layers

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shapes, dtype="float32", scales=None):
    """The same numbers for both packages: numpy f32 draws, cast to dtype."""
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    arrs = [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in zip(shapes, scales)]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype, f32, bf16):
    return bf16 if dtype == "bfloat16" else f32


class TestFlashAttention:
    @pytest.mark.parametrize("BH,S,D,bq,bk", [
        (2, 128, 64, 32, 32),
        (3, 256, 128, 64, 128),
        (1, 64, 32, 64, 64),
        (2, 128, 64, 128, 32),   # bq > bk
        (2, 96, 64, 32, 96),     # uneven grid
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_sweep(self, BH, S, D, bq, bk, dtype, causal):
        (jq, jk, jv), (tq, tk, tv) = _inputs(0, [(BH, S, D)] * 3, dtype)
        ref = jax_flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
        out = flash_attention(tq, tk, tv, causal=causal)
        assert out.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(dtype, 2e-5, 3e-2),
                                   rtol=1e-2)

    @pytest.mark.parametrize("B,S,H,KV,D,bq,bk", [
        (2, 64, 8, 2, 32, 32, 32),    # the reference test's GQA case
        (1, 40, 4, 1, 16, 32, 16),    # S padded to 64 (q) and 48 (kv): offset mask
        (2, 20, 4, 4, 16, 256, 256),  # blocks larger than S: no padding
    ])
    def test_gqa_wrapper(self, B, S, H, KV, D, bq, bk):
        (jq, jk, jv), (tq, tk, tv) = _inputs(1, [(B, S, H, D), (B, S, KV, D), (B, S, KV, D)])
        ref = jax_gqa_flash_attention(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                                      interpret=True)
        out = gqa_flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=3e-5, rtol=1e-3)

    def test_gqa_wrapper_is_always_causal(self):
        """``ops.py:61`` passes causal=True whatever it is given; so does the port."""
        _, (tq, tk, tv) = _inputs(2, [(1, 16, 2, 8)] * 3)
        a = gqa_flash_attention(tq, tk, tv, causal=False)
        b = gqa_flash_attention(tq, tk, tv, causal=True)
        torch.testing.assert_close(a, b, atol=0, rtol=0)

    def test_matches_jax_model_attention(self):
        """The port's kernel route agrees with the reference model's chunked attention."""
        (jq, jk, jv), (tq, tk, tv) = _inputs(3, [(1, 64, 4, 32)] * 3)
        ref = jax_layers.chunked_attention(jq, jk, jv, causal=True, q_chunk=16)
        out = gqa_flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=32)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=3e-5, rtol=1e-3)


class TestSwiGLU:
    @pytest.mark.parametrize("M,D,F,bm,bf,bk", [
        (64, 128, 256, 32, 128, 64),
        (128, 256, 128, 64, 64, 128),
        (32, 64, 64, 32, 64, 64),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep(self, M, D, F, bm, bf, bk, dtype):
        (jx, jg, ju), (tx, tg, tu) = _inputs(
            4, [(M, D), (D, F), (D, F)], dtype, scales=[1.0, D ** -0.5, D ** -0.5])
        ref = jax_swiglu_matmul(jx, jg, ju, block_m=bm, block_f=bf, block_k=bk, interpret=True)
        out = swiglu_matmul(tx, tg, tu)
        assert out.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=_tol(dtype, 1e-4, 5e-2),
                                   rtol=2e-2)

    def test_fused_wrapper_pads_m(self):
        (jx, jg, ju), (tx, tg, tu) = _inputs(
            5, [(2, 24, 64), (64, 128), (64, 128)], scales=[1.0, 1 / 8, 1 / 8])
        ref = jax_fused_swiglu(jx, jg, ju, block_m=32, block_f=128, block_k=64, interpret=True)
        out = fused_swiglu(tx, tg, tu, block_m=32)  # M = 48 padded to 64
        assert out.shape == (2, 24, 128)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-4)

    def test_mlp_matches_jax_mlp(self):
        (jx, jg, ju, jd), (tx, tg, tu, td) = _inputs(
            6, [(1, 32, 64), (64, 128), (64, 128), (128, 64)], scales=[1.0, 1 / 8, 1 / 8, 1 / 11])
        ref = jax_layers.mlp({"wg": jg, "wu": ju, "wd": jd}, jx)
        out = layers.mlp({"wg": tg, "wu": tu, "wd": td}, tx)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-4, rtol=1e-3)


def _ssd_inputs(seed, BH, S, P, N, dtype="float32", dt_shift=0.0):
    """x, dt, A, B, C for both packages, drawn as ``tests/test_kernels.py``
    draws them: dt = softplus(normal), A = -exp(normal / 2), B and C at 0.5.
    ``dt_shift`` moves dt to softplus(normal - dt_shift): at 4 (dt ~0.02) a
    chunk of 64 decays by 0.1-0.4 instead of ~e^-50, and the carried state
    counts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((BH, S)) - dt_shift).astype(np.float32)
    A = -np.exp(rng.standard_normal(BH) * 0.5).astype(np.float32)
    B = (rng.standard_normal((BH, S, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((BH, S, N)) * 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(x).astype(jd), jnp.asarray(dt), jnp.asarray(A),
             jnp.asarray(B).astype(jd), jnp.asarray(C).astype(jd)],
            [torch.from_numpy(x).to(td), torch.from_numpy(dt), torch.from_numpy(A),
             torch.from_numpy(B).to(td), torch.from_numpy(C).to(td)])


def _ssd_tol(ref, dtype):
    scale = max(float(np.abs(_f32(ref)).max()), 1.0)
    return (0.15 if dtype == "bfloat16" else 2e-3) * scale


class TestSSDScan:
    @pytest.mark.parametrize("BH,S,P,N,bs", [
        (2, 128, 32, 64, 32),
        (3, 256, 64, 128, 64),
        (2, 128, 64, 32, 128),
        (1, 64, 16, 16, 16),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep(self, BH, S, P, N, bs, dtype):
        jin, tin = _ssd_inputs(11, BH, S, P, N, dtype)
        ref = jax_ssd_scan(*jin, block_s=bs, interpret=True)
        out = ssd_scan(*tin)
        assert out.dtype == DTYPES[dtype][1] and out.shape == (BH, S, P)
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=_ssd_tol(ref, dtype))

    @pytest.mark.parametrize("S", [100, 37])
    def test_final_state_of_ragged_sequence(self, S):
        """The state the scan returns is the reference's ``_ssd_chunked``
        state after the last step, on a length no chunk divides; y with the
        state is y without it."""
        jin, (x, dt, A, B, C) = _ssd_inputs(12, 2, S, 16, 32)
        y, h = ssd_scan(x, dt, A, B, C, return_state=True)
        assert h.dtype == torch.float32 and h.shape == (2, 16, 32)
        torch.testing.assert_close(y, ssd_scan(x, dt, A, B, C), atol=0, rtol=0)
        # the two sequences as two heads (and two groups) of one batch row
        jx, jdt, jA, jB, jC = jin
        ref_y, ref_h = jax_ssm._ssd_chunked(
            jnp.moveaxis(jx, 0, 1)[None], jnp.moveaxis(jdt, 0, 1)[None], jA,
            jnp.moveaxis(jB, 0, 1)[None], jnp.moveaxis(jC, 0, 1)[None], chunk=16)
        np.testing.assert_allclose(_f32(y), _f32(jnp.moveaxis(ref_y[0], 1, 0)), rtol=0,
                                   atol=_ssd_tol(ref_y, "float32"))
        np.testing.assert_allclose(_f32(h), _f32(ref_h[0]), rtol=0,
                                   atol=_ssd_tol(ref_h, "float32"))

    @pytest.mark.parametrize("B,S,H,G,bs", [
        (2, 64, 4, 1, 16),    # the reference test's mixer case
        (1, 40, 4, 2, 16),    # groups broadcast to heads; S no multiple of the block
        (2, 20, 2, 2, 256),   # block larger than S
    ])
    def test_mixer_matches_jax_mixer(self, B, S, H, G, bs):
        P, N = 16, 32
        rng = np.random.default_rng(13)
        x = rng.standard_normal((B, S, H, P)).astype(np.float32)
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
        Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        ref = jax_ssd_mixer(*map(jnp.asarray, (x, dt, A, Bm, Cm)), block_s=bs, interpret=True)
        out = ssd_mixer(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
        assert out.shape == (B, S, H, P)
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=_ssd_tol(ref, "float32"))
        # the model's chunked SSD, on y and on the final state
        ref_y, ref_h = jax_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=bs)
        y, h = ssd_mixer(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), return_state=True)
        assert h.shape == (B, H, P, N) and h.dtype == torch.float32
        np.testing.assert_allclose(_f32(y), _f32(ref_y), rtol=0, atol=_ssd_tol(ref_y, "float32"))
        np.testing.assert_allclose(_f32(h), _f32(ref_h), rtol=0, atol=_ssd_tol(ref_h, "float32"))

    def test_mixer_matches_model_ssd(self):
        """Port of ``tests/test_kernels.py::test_mixer_matches_model_ssd``,
        at that test's tolerance (atol 5e-3, rtol 1e-2)."""
        B, S, H, P, N, G = 2, 64, 4, 16, 32, 1
        rng = np.random.default_rng(14)
        x = rng.standard_normal((B, S, H, P)).astype(np.float32)
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
        Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        ref, _ = jax_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16)
        out = ssd_mixer(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=5e-3, rtol=1e-2)


def _three_phase_flat(x, dt, A, B, C, **kw):
    """The emulation on ``[BH, S, *]`` operands, each sequence a batch row
    of one head and one group, as ``ssd_scan`` hands them to the kernel."""
    out = ssd_scan_three_phase(x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None],
                               C[:, :, None], **kw)
    if kw.get("return_state"):
        return out[0][:, :, 0], out[1][:, 0]
    return out[:, :, 0]


def _card_ratio(out, ref, state=False):
    """Largest error over the card's tolerance (``chip_smoke.py``'s
    SSD_Y_TOL / SSD_STATE_TOL, ``tests/test_torch_card.py::_ssd_close``),
    element by element: y to 1e-4·max(|ref|, 1) plus 2**-7·|ref| in bf16,
    the f32 state to 1e-4·max(|ref|, 1).  The check fails above 1."""
    out, ref = out.float(), ref.float()
    atol = 1e-4 * max(float(ref.abs().max()), 1.0)
    rtol = 2.0 ** -7 if not state else 0.0
    return float(((out - ref).abs() / (atol + rtol * ref.abs())).max())


class TestThreePhase:
    """The ``wgmma`` SSD-scan kernel's design, emulated on the CPU
    (``ref.ssd_scan_three_phase``): chunks of 64, the three phases, and the
    f32 operands of the bf16 tensor cores as hi + lo halves."""

    @pytest.mark.parametrize("BH,S,P,N,bs", [
        (2, 128, 32, 64, 32),
        (3, 256, 64, 128, 64),
        (2, 128, 64, 32, 128),
        (1, 64, 16, 16, 16),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_pallas_kernel(self, BH, S, P, N, bs, dtype):
        jin, tin = _ssd_inputs(11, BH, S, P, N, dtype)
        ref = jax_ssd_scan(*jin, block_s=bs, interpret=True)
        out = _three_phase_flat(*tin)
        assert out.dtype == DTYPES[dtype][1] and out.shape == (BH, S, P)
        np.testing.assert_allclose(_f32(out), _f32(ref), rtol=0, atol=_ssd_tol(ref, dtype))

    @pytest.mark.parametrize("B,S,H,G,bs", [(2, 64, 4, 1, 16), (1, 40, 4, 2, 16), (2, 20, 2, 2, 256)])
    def test_matches_model_chunked_ssd(self, B, S, H, G, bs):
        """y and the final state against the reference's ``_ssd_chunked``,
        groups read by head in place (no broadcast)."""
        P, N = 16, 32
        rng = np.random.default_rng(13)
        x = rng.standard_normal((B, S, H, P)).astype(np.float32)
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
        A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
        Bm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        Cm = (rng.standard_normal((B, S, G, N)) * 0.5).astype(np.float32)
        ref_y, ref_h = jax_ssm._ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=bs)
        y, h = ssd_scan_three_phase(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), return_state=True)
        np.testing.assert_allclose(_f32(y), _f32(ref_y), rtol=0, atol=_ssd_tol(ref_y, "float32"))
        np.testing.assert_allclose(_f32(h), _f32(ref_h), rtol=0, atol=_ssd_tol(ref_h, "float32"))

    @pytest.mark.parametrize("BH,S,P,N,dt_shift", [
        (2, 100, 64, 128, 0.0), (1, 37, 64, 16, 0.0), (2, 64, 64, 64, 0.0), (1, 1, 64, 128, 0.0),
        (2, 200, 64, 32, 0.0), (2, 300, 64, 128, 4.0), (2, 300, 64, 16, 4.0),
    ])
    def test_within_card_tolerance_of_exact_recurrence(self, BH, S, P, N, dt_shift):
        """bf16 at the kernel's widths: y and the state within the unchanged
        tolerances the card holds the kernel to, also where the carried state
        counts (dt_shift 4)."""
        _, tin = _ssd_inputs(15, BH, S, P, N, "bfloat16", dt_shift=dt_shift)
        y, h = _three_phase_flat(*tin, return_state=True)
        ry, rh = ssd_scan_ref(*tin, return_state=True)
        assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
        assert _card_ratio(y, ry) <= 1.0
        assert _card_ratio(h, rh, state=True) <= 1.0

    @pytest.mark.parametrize("BH,S,P,N", [(2, 100, 64, 128), (2, 64, 64, 64)])
    def test_dropping_lo_halves_fails(self, BH, S, P, N):
        """Planted fault: operands rounded once to bf16 (the lo halves
        dropped).  The state misses its tolerance many times over."""
        _, tin = _ssd_inputs(15, BH, S, P, N, "bfloat16")
        y, h = _three_phase_flat(*tin, return_state=True, lo=False)
        _, rh = ssd_scan_ref(*tin, return_state=True)
        assert _card_ratio(h, rh, state=True) > 4.0

    def test_grouped_strided_views_equal_repeated_copies(self):
        """Head h reads group h // (H/G) from strided views of one conv-output
        row, as the kernel does; the same as broadcast contiguous copies."""
        B, S, H, G, P, N = 2, 70, 8, 2, 64, 32
        rng = np.random.default_rng(16)
        buf = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * G * N)).astype(np.float32)
                               * 0.5).to(torch.bfloat16)
        x = buf[..., :H * P].reshape(B, S, H, P)
        Bm = buf[..., H * P:H * P + G * N].reshape(B, S, G, N)
        Cm = buf[..., H * P + G * N:].reshape(B, S, G, N)
        dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32))
        A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32))
        y, h = ssd_scan_three_phase(x, dt, A, Bm, Cm, return_state=True)
        rep = H // G
        ry, rh = ssd_scan_three_phase(x.contiguous(), dt, A,
                                      Bm.repeat_interleave(rep, dim=2).contiguous(),
                                      Cm.repeat_interleave(rep, dim=2).contiguous(),
                                      return_state=True)
        torch.testing.assert_close(y, ry, atol=0, rtol=0)
        torch.testing.assert_close(h, rh, atol=0, rtol=0)


class TestChunkedAttention:
    """The port's plain ``chunked_attention`` (decode attention) against the reference's."""

    @pytest.mark.parametrize("kv_len", [[5, 32, 17], 9])
    def test_decode_form(self, kv_len):
        """q_chunk=1 over a bf16 cache with a per-slot (or shared) valid length.
        Both round the probabilities and the output to bf16 after identical
        f32 math, so they may differ by about one bf16 ulp of the output."""
        (jq, jk, jv), (tq, tk, tv) = _inputs(7, [(3, 1, 4, 16), (3, 32, 2, 16), (3, 32, 2, 16)])
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
        ref = jax_layers.chunked_attention(jq, jk, jv, causal=False, q_chunk=1,
                                           kv_len=jnp.asarray(kv_len))
        out = layers.chunked_attention(tq, tk, tv, causal=False, q_chunk=1,
                                       kv_len=torch.tensor(kv_len))
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=2e-2, rtol=0)

    def test_causal_chunks_with_offset(self):
        (jq, jk, jv), (tq, tk, tv) = _inputs(8, [(2, 24, 4, 16), (2, 30, 2, 16), (2, 30, 2, 16)])
        ref = jax_layers.chunked_attention(jq, jk, jv, causal=True, q_chunk=7, q_offset=6)
        out = layers.chunked_attention(tq, tk, tv, causal=True, q_chunk=7, q_offset=6)
        np.testing.assert_allclose(_f32(out), _f32(ref), atol=1e-5, rtol=1e-5)


class TestWrappers:
    def test_cpu_path_launches_nothing(self):
        """The counters move only where a CUDA kernel is launched."""
        libs = (FLASH_LIBRARY, SWIGLU_LIBRARY, SSD_LIBRARY)
        before = [lib.launches for lib in libs]
        _, (tq, tk, tv) = _inputs(9, [(2, 16, 8)] * 3)
        flash_attention(tq, tk, tv)
        swiglu_matmul(tq[0], tk[0].T.contiguous(), tv[0].T.contiguous())
        ssd_scan(*_ssd_inputs(9, 2, 16, 8, 8)[1], return_state=True)
        assert [lib.launches for lib in libs] == before

    def test_plain_versions_are_the_cpu_route(self):
        _, (tq, tk, tv) = _inputs(10, [(2, 16, 8)] * 3)
        torch.testing.assert_close(flash_attention(tq, tk, tv, causal=True),
                                   flash_attention_ref(tq, tk, tv, causal=True), atol=0, rtol=0)
        x, wg, wu = tq[0], tk[0].T.contiguous(), tv[0].T.contiguous()
        torch.testing.assert_close(swiglu_matmul(x, wg, wu), swiglu_ref(x, wg, wu),
                                   atol=0, rtol=0)
        _, ssd_in = _ssd_inputs(10, 2, 16, 8, 8)
        torch.testing.assert_close(ssd_scan(*ssd_in), ssd_scan_ref(*ssd_in), atol=0, rtol=0)

    def test_other_devices_raise(self, monkeypatch):
        """No silent fallback: a tensor that is neither on the CPU, on a CUDA
        card nor on ``meta`` is refused, and no device but the CPU is
        computed by the plain version.  ``meta`` tensors take the CUDA route
        without launching (the shape-only path of the launch accounting):
        empty outputs, never the plain version's."""
        from repro_torch.kernels._build import check_cuda_operands

        other = types.SimpleNamespace(device=torch.device("xpu"), dtype=torch.float32)
        for name in ("flash_attention", "swiglu_matmul", "ssd_scan"):
            with pytest.raises(ValueError, match="CPU, CUDA or meta"):
                check_cuda_operands(name, (other,), (torch.float32,))

        def plain(*a, **k):
            raise AssertionError("the plain version ran on meta tensors")

        for module, ref in (("flash_attention", "flash_attention_ref"),
                            ("swiglu_matmul", "swiglu_ref"), ("ssd_scan", "ssd_scan_ref")):
            monkeypatch.setattr(importlib.import_module(f"repro_torch.kernels.{module}"), ref,
                                plain)
        q = torch.empty((2, 16, 8), device="meta")
        assert flash_attention(q, q, q).is_meta
        x, w = torch.empty((4, 8), device="meta"), torch.empty((8, 16), device="meta")
        assert swiglu_matmul(x, w, w).is_meta
        x, dt, B = (torch.empty(s, device="meta") for s in ((2, 16, 8), (2, 16), (2, 16, 8)))
        assert ssd_scan(x, dt, dt[:, 0].contiguous(), B, B).is_meta
