"""The backward kernels' plain versions, selectors and ``meta`` route, on the
CPU, against the JAX package.

The card's backward of flash attention (``wgmma_bwd``) and of the fused
SwiGLU (``wgmma_bwd``, ``experts_wgmma_bwd``) are CUDA kernels with no CPU
mode; what they compute is :func:`repro_torch.kernels.ref.flash_attention_bwd_ref`
(from the forward's output and per-row logsumexp; the flash kernel's
tiling of it is :func:`repro_torch.kernels.ref.flash_attention_bwd_tiles`,
held here too, with a skipped query step as its planted fault) and
:func:`repro_torch.kernels.ref.swiglu_bwd_ref` (dg and du, which
``swiglu_matmul.swiglu_grads`` turns into dx, dwg, dwu).  These tests hold
those plain versions against ``jax.vjp`` of the JAX package's references
(``repro.kernels.ref``), the same numpy inputs on both sides in f32; the
kernels themselves are held against the plain versions on the card
(``tests/test_torch_card.py``, ``chip_smoke.py``).

Tolerances, all f32 on both sides, relative to each gradient's largest
magnitude: the two sides differ in summation order and in how the
probabilities are formed (exp(s - lse) from a saved logsumexp against
softmax's own max and sum), which moves a gradient by a few f32 ulps of the
largest one (measured: <= 1.1e-6 for flash, 3.5e-7 for SwiGLU): 2e-5
(``GRAD_TOL``).  The logsumexp itself is held to 1e-6 of its magnitude
(measured 1.1e-7).  Every planted fault of ``chip_smoke.py`` (the causal flag
cleared, dg and du swapped) misses by O(1).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import (
    LIBRARIES, flash_attention, flash_attention_bwd_ref,
    select_flash_bwd_variant, select_swiglu_bwd_variant, swiglu_bwd_ref, swiglu_experts,
    swiglu_matmul,
)
from repro_torch.kernels._work import WorkLog
from repro_torch.kernels.ref import flash_attention_bwd_tiles, flash_attention_ref

from _torch_cnn_cases import one_intra_op_thread  # noqa: F401  (autouse)

fa = importlib.import_module("repro_torch.kernels.flash_attention")
sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")

GRAD_TOL = 2e-5
LSE_TOL = 1e-6
BF16, F32 = torch.bfloat16, torch.float32


def _np(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _masked_scores(q, k, causal, scale):
    """The JAX reference's scaled, masked scores (its own formula)."""
    s = jnp.einsum("bqd,bkd->bqk", q, k) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = jnp.arange(Sk)[None, :] <= (jnp.arange(Sq)[:, None] + (Sk - Sq))
        s = jnp.where(mask[None], s, -1e30)
    return s


# (Sq, Sk, D, Dv): Sq = Sk and Sq < Sk at every head-dim class of the kernel
# (16/16 in the 32/32 tile, 64/64, HuBERT's 80, MLA's 192/128), a ragged S of
# 100, and Sq > Sk (rows that see no key when causal)
FLASH_SHAPES = [(64, 64, 16, 16), (48, 80, 16, 16), (64, 64, 64, 64), (40, 96, 64, 64),
                (100, 100, 64, 64), (100, 100, 80, 80), (60, 100, 80, 80),
                (64, 64, 192, 128), (40, 100, 192, 128), (100, 100, 192, 128),
                (90, 40, 64, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", FLASH_SHAPES)
def test_flash_lse_matches_logsumexp(Sq, Sk, D, Dv, causal):
    q, k, v = _np(1, (2, Sq, D), (2, Sk, D), (2, Sk, Dv))
    scale = D ** -0.5
    o, lse = flash_attention_ref(*_t(q, k, v), causal=causal, scale=scale, return_lse=True)
    want = jax.nn.logsumexp(_masked_scores(q, k, causal, scale), axis=-1)
    assert lse.dtype == F32 and tuple(lse.shape) == (2, Sq)
    assert np.allclose(lse.numpy(), np.asarray(want), rtol=LSE_TOL, atol=LSE_TOL)
    assert _rel(o.numpy(), jax_ref.flash_attention_ref(q, k, v, causal, scale)) <= GRAD_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", FLASH_SHAPES)
def test_flash_bwd_ref_matches_jax_vjp(Sq, Sk, D, Dv, causal):
    """dq, dk, dv from the saved o and lse against ``jax.vjp`` of the
    reference's attention."""
    q, k, v = _np(2, (3, Sq, D), (3, Sk, D), (3, Sk, Dv))
    (do,) = _np(3, (3, Sq, Dv))
    scale = 0.7 * D ** -0.5
    o, lse = flash_attention_ref(*_t(q, k, v), causal=causal, scale=scale, return_lse=True)
    got = flash_attention_bwd_ref(*_t(q, k, v), o, lse, torch.from_numpy(do), causal, scale)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.flash_attention_ref(q, k, v, causal, scale), q, k, v)
    want = vjp(do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == F32 and tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= GRAD_TOL, (name, _rel(g.numpy(), w))


def test_flash_bwd_ref_planted_fault():
    """The fault chip_smoke.py plants in the kernel's launch, the causal flag
    cleared, misses jax.vjp by far more than any tolerance."""
    q, k, v, do = _np(4, (2, 64, 64), (2, 64, 64), (2, 64, 64), (2, 64, 64))
    o, lse = flash_attention_ref(*_t(q, k, v), causal=True, return_lse=True)
    got = flash_attention_bwd_ref(*_t(q, k, v), o, lse, torch.from_numpy(do), False)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.flash_attention_ref(q, k, v, True), q, k, v)
    assert max(_rel(g.numpy(), w) for g, w in zip(got, vjp(do))) > 0.3


# --------------------------------------------------------------------------- #
# wgmma_bwd's tiling (ref.flash_attention_bwd_tiles) against jax.vjp
# --------------------------------------------------------------------------- #
def _bwd_tiles(D, Dv):
    """(bq, bkq) of the kernel's tile class for these head dims, as
    ``dispatch_bwd`` in ``csrc/flash_attention.cu`` picks it by the wider
    one: 64/64 up to 64, 64/128 up to 80 and up to 128, 32/64 above."""
    w = max(D, Dv)
    return (64, 64) if w <= 64 else (64, 128) if w <= 128 else (32, 64)


def _jax_flash_grads(q, k, v, do, causal, scale):
    _, vjp = jax.vjp(lambda q, k, v: jax_ref.flash_attention_ref(q, k, v, causal, scale), q, k, v)
    return vjp(do)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", FLASH_SHAPES)
def test_flash_bwd_tiles_match_jax_vjp(Sq, Sk, D, Dv, causal):
    """The kernel's tiles at each shape's tile class (128 keys a dK/dV CTA
    in halves of 64, query steps of the class's rows from the causal
    diagonal, ragged ends zero-padded and masked, dQ summed over the
    class's key tiles in the kernel's order) give ``jax.vjp``'s
    gradients."""
    q, k, v = _np(8, (3, Sq, D), (3, Sk, D), (3, Sk, Dv))
    (do,) = _np(9, (3, Sq, Dv))
    scale = 0.7 * D ** -0.5
    o, lse = flash_attention_ref(*_t(q, k, v), causal=causal, scale=scale, return_lse=True)
    bq, bkq = _bwd_tiles(D, Dv)
    got = flash_attention_bwd_tiles(*_t(q, k, v), o, lse, torch.from_numpy(do), causal, scale,
                                    bq=bq, bkq=bkq)
    for name, g, w in zip(("dq", "dk", "dv"), got, _jax_flash_grads(q, k, v, do, causal, scale)):
        assert g.dtype == F32 and tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= GRAD_TOL, (name, _rel(g.numpy(), w))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(300, 300, 32, 32), (130, 300, 16, 16),
                                        (300, 130, 16, 16), (200, 260, 80, 80),
                                        (300, 300, 128, 128), (260, 200, 192, 128)])
def test_flash_bwd_tiles_span_tiles(Sq, Sk, D, Dv, causal):
    """Several dK/dV CTAs, query steps and dQ key tiles (S past 256, Sq
    above and below Sk), at each shape's tile class: the tiling against the
    plain version in f64, within 1e-10 of each gradient's largest
    magnitude."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _np(10, (2, Sq, D), (2, Sk, D), (2, Sk, Dv), (2, Sq, Dv)))
    o, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    bq, bkq = _bwd_tiles(D, Dv)
    got = flash_attention_bwd_tiles(q, k, v, o, lse, do, causal, bq=bq, bkq=bkq)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float64, name
        assert _rel(g.numpy(), w.numpy()) <= 1e-10, (name, _rel(g.numpy(), w.numpy()))


@pytest.mark.parametrize("tile", [0, 1])
def test_flash_bwd_tiles_planted_fault(tile):
    """A query step the dK/dV walk skips misses jax.vjp by O(1)."""
    q, k, v, do = _np(11, (2, 100, 64), (2, 100, 64), (2, 100, 64), (2, 100, 64))
    o, lse = flash_attention_ref(*_t(q, k, v), causal=True, return_lse=True)
    got = flash_attention_bwd_tiles(*_t(q, k, v), o, lse, torch.from_numpy(do), True,
                                    drop_q_tile=tile)
    want = _jax_flash_grads(q, k, v, do, True, 64 ** -0.5)
    assert _rel(got[0].numpy(), want[0]) <= GRAD_TOL  # dQ's walk is whole
    assert max(_rel(g.numpy(), w) for g, w in zip(got[1:], want[1:])) > 0.1


def _jax_swiglu_grads(x, wg, wu, dout, experts):
    fn = jax.vmap(jax_ref.swiglu_ref) if experts else jax_ref.swiglu_ref
    _, vjp = jax.vjp(fn, x, wg, wu)
    return vjp(dout)


@pytest.mark.parametrize("M,D,F", [(11, 16, 24), (64, 48, 40), (100, 64, 96)])
@pytest.mark.parametrize("E", [None, 3])
def test_swiglu_bwd_ref_matches_jax_vjp(E, M, D, F):
    """dg and du, assembled by ``swiglu_grads`` into (dx, dwg, dwu), against
    ``jax.vjp`` of the reference's SwiGLU: one product and per expert."""
    lead = () if E is None else (E,)
    x, wg, wu = _np(5, (*lead, M, D), (*lead, D, F), (*lead, D, F))
    wg, wu = wg * D ** -0.5, wu * D ** -0.5  # the model's scale: g of order one
    (dout,) = _np(6, (*lead, M, F))
    tx, twg, twu, tdout = _t(x, wg, wu, dout)
    dg, du = swiglu_bwd_ref(tx, twg, twu, tdout)
    assert dg.shape == du.shape == tdout.shape
    got = sw.swiglu_grads(tx, twg, twu, dg, du)
    want = _jax_swiglu_grads(x, wg, wu, dout, E is not None)
    for name, g, w in zip(("dx", "dwg", "dwu"), got, want):
        assert tuple(g.shape) == w.shape, name
        assert _rel(g.numpy(), w) <= GRAD_TOL, (name, _rel(g.numpy(), w))
    # the explicit VJP (the f32 route's backward) is the same function
    for g, w in zip(sw.swiglu_vjp(tx, twg, twu, tdout), got):
        assert _rel(g.numpy(), w.numpy()) <= GRAD_TOL


def test_swiglu_bwd_ref_planted_fault():
    """dg and du swapped (the fault chip_smoke.py plants in the kernel's
    launch) misses jax.vjp by far more than any tolerance."""
    x, wg, wu, dout = _np(7, (32, 16), (16, 24), (16, 24), (32, 24))
    wg, wu = wg / 4, wu / 4
    tx, twg, twu, tdout = _t(x, wg, wu, dout)
    dg, du = swiglu_bwd_ref(tx, twg, twu, tdout)
    got = sw.swiglu_grads(tx, twg, twu, du, dg)
    want = _jax_swiglu_grads(x, wg, wu, dout, False)
    assert max(_rel(g.numpy(), w) for g, w in zip(got, want)) > 0.3


# --------------------------------------------------------------------------- #
# the selectors: the card's train shapes take the kernels, f32 the VJPs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("D,Dv", [(D, Dv) for D in range(16, 193, 16) for Dv in range(16, 129, 16)])
def test_flash_bwd_selector_takes_the_kernel(D, Dv):
    """Every bf16 head-dim pair the ``mma`` forward takes: D a multiple of
    16 up to 192, Dv one up to 128."""
    assert select_flash_bwd_variant(D, Dv, BF16) == "wgmma_bwd"


@pytest.mark.parametrize("D,Dv,dtype", [(64, 64, F32), (192, 128, F32), (40, 40, BF16),
                                        (64, 24, BF16), (208, 128, BF16), (64, 144, BF16)])
def test_flash_bwd_selector_takes_the_vjp(D, Dv, dtype):
    """Wherever the forward is ``cuda_core``: f32, head dims that are not
    multiples of 16, or past 192/128."""
    assert fa.select_variant(D, Dv, dtype) == "cuda_core"
    assert select_flash_bwd_variant(D, Dv, dtype) == "vjp"


@pytest.mark.parametrize("M", [1, 8, 63, 64, 120, 4096])
@pytest.mark.parametrize("D,F", [(2048, 5632), (2048, 1408), (4096, 14336), (1280, 5120)])
def test_swiglu_bwd_selector_takes_the_kernel(M, D, F):
    """Every bf16 call with D and F multiples of 8, at any M: the decode
    forward's rows too."""
    assert select_swiglu_bwd_variant(M, D, F, BF16) == "wgmma_bwd"
    assert select_swiglu_bwd_variant(M, D, F, BF16, experts=True) == "experts_wgmma_bwd"


@pytest.mark.parametrize("M,D,F,dtype", [(4096, 2048, 5632, F32), (8, 2048, 5632, F32),
                                         (64, 100, 70, BF16), (64, 2052, 5632, BF16),
                                         (64, 2048, 5636, BF16)])
def test_swiglu_bwd_selector_takes_the_vjp(M, D, F, dtype):
    assert select_swiglu_bwd_variant(M, D, F, dtype) == "vjp"
    assert select_swiglu_bwd_variant(M, D, F, dtype, experts=True) == "vjp"


# --------------------------------------------------------------------------- #
# the backward on meta: one record, one launch counted, nothing launched
# --------------------------------------------------------------------------- #
def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=True)


def _counts():
    return {lib.name: dict(lib.counts) for lib in LIBRARIES}


def _moved(before):
    return {(name, v): n - before[name][v] for name, row in _counts().items()
            for v, n in row.items() if n != before[name][v]}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(100, 130, 64, 64), (64, 64, 192, 128),
                                        (100, 100, 80, 80)])
def test_flash_backward_on_meta(Sq, Sk, D, Dv, causal):
    q, k, v = _meta(6, Sq, D), _meta(6, Sk, D), _meta(6, Sk, Dv)
    o = flash_attention(q, k, v, causal=causal)
    before = _counts()
    with WorkLog() as log:
        o.sum().backward()
    assert [tuple(t.grad.shape) for t in (q, k, v)] == [(6, Sq, D), (6, Sk, D), (6, Sk, Dv)]
    assert all(t.grad.device.type == "meta" and t.grad.dtype == BF16 for t in (q, k, v))
    assert log.calls == {("flash_attention", "wgmma_bwd"): [
        1, *fa.work_bwd(6, Sq, Sk, D, causal, 2, Dv)]}
    assert log.aten == {}  # the kernel's work is its record
    assert _moved(before) == {("flash_attention", "wgmma_bwd"): 1}


@pytest.mark.parametrize("M", [8, 100])
@pytest.mark.parametrize("E", [None, 4])
def test_swiglu_backward_on_meta(E, M):
    lead = () if E is None else (E,)
    D, F = 256, 96
    x, wg, wu = _meta(*lead, M, D), _meta(*lead, D, F), _meta(*lead, D, F)
    o = swiglu_matmul(x, wg, wu) if E is None else swiglu_experts(x, wg, wu)
    before = _counts()
    with WorkLog() as log:
        o.sum().backward()
    assert [tuple(t.grad.shape) for t in (x, wg, wu)] == [(*lead, M, D), (*lead, D, F),
                                                          (*lead, D, F)]
    variant = "wgmma_bwd" if E is None else "experts_wgmma_bwd"
    assert log.calls[("swiglu_matmul", variant)] == [1, *sw.work_bwd(M, D, F, 2, E or 1)]
    # the four products around the kernel: their aten FLOPs, as the VJP component
    products = 4 * 2.0 * (E or 1) * M * D * F
    assert set(log.calls) == {("swiglu_matmul", variant), ("swiglu_matmul", "vjp")}
    assert log.calls[("swiglu_matmul", "vjp")][1] == products
    assert log.unbatched == 0.0  # the backward's products are not the saved forward's
    assert _moved(before) == {("swiglu_matmul", variant): 1}


def test_f32_backward_on_meta_takes_the_vjps():
    """The ``"vjp"`` routes: no backward kernel is counted."""
    q = _meta(2, 64, 64, dtype=F32)
    x, w = _meta(64, 64, dtype=F32), _meta(64, 32, dtype=F32)
    before = _counts()
    with WorkLog() as log:
        (flash_attention(q, q, q).sum() + swiglu_matmul(x, w, w).sum()).backward()
    assert {k for k in log.calls if k[1] == "vjp"} == {("flash_attention", "vjp"),
                                                       ("swiglu_matmul", "vjp")}
    assert _moved(before) == {("flash_attention", "cuda_core"): 1,
                              ("swiglu_matmul", "cuda_core"): 1}


def test_backward_launches_raise_on_cpu_tensors():
    """A backward launch takes CUDA (or meta) tensors: CPU tensors never
    reach it (their autograd runs through the plain versions), and one
    given to it raises rather than computing anything."""
    before = _counts()
    q = torch.zeros(2, 64, 64, dtype=BF16)
    with pytest.raises(ValueError):
        fa._launch_bwd(q, q, q, q, q, torch.zeros(2, 64), True, 0.125)
    x, w = torch.zeros(64, 64, dtype=BF16), torch.zeros(64, 32, dtype=BF16)
    with pytest.raises(ValueError):
        sw._launch_bwd(x, w, w, torch.zeros(64, 32, dtype=BF16))
    assert _counts() == before
