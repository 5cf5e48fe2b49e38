"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These need a CUDA card (the kernels are CUDA C++ with no CPU mode) and skip
without one.  The file imports neither JAX nor the reference, so it also runs
on a machine without them; there, skip the repository's conftest, which
imports the reference:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_card.py

Each call goes through the kernel variant its wrapper's selector picks:
f32 to the CUDA-core kernels, bf16 to the tensor-core ones (SwiGLU: the
decode kernel below 64 rows, wgmma from 64; flash: mma.sync for head dims
that are multiples of 16; the SSD scan: wgmma for head dim 64 and a state
width that is a multiple of 16 up to 128) unless the shapes rule them out.  Tolerances are
those of ``tests/test_kernels.py`` for flash attention and SwiGLU; ssd_scan
is held element by element against the exact sequential recurrence, as
``chip_smoke.py`` holds it (see ``_ssd_close``).  The backward kernels
(flash ``wgmma_bwd``, SwiGLU ``wgmma_bwd`` and ``experts_wgmma_bwd``) are
held against their plain versions and launched twice for the same bits
(``test_flash_wgmma_bwd``, ``test_swiglu_wgmma_bwd``), and through the
autograd Functions against autograd through the plain versions
(``test_*_vjp_on_card``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, fused_swiglu,
    gqa_flash_attention, select_experts_variant, select_flash_variant, select_ssd_variant,
    select_swiglu_variant, ssd_mixer, ssd_scan, swiglu_experts, swiglu_matmul,
)
from repro_torch.kernels.ref import (
    flash_attention_ref, ssd_scan_ref, swiglu_experts_ref, swiglu_ref,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _inputs(card, seed, shapes, dtype, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    return [torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32)).to(card, dtype)
            for s, sc in zip(shapes, scales)]


def _tol(dtype, f32, bf16):
    return bf16 if dtype == torch.bfloat16 else f32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D", [(100, 130, 64), (130, 100, 64), (256, 256, 128), (64, 64, 32)])
def test_flash_kernel(card, dtype, causal, Sq, Sk, D):
    q, k, v = _inputs(card, 0, [(2, Sq, D), (2, Sk, D), (2, Sk, D)], dtype)
    before = FLASH_LIBRARY.launches
    out = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.launches == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype, 2e-5, 3e-2), rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(8, 256, 96), (200, 256, 96), (5, 100, 70)])
def test_swiglu_kernel(card, dtype, M, D, F):
    x, wg, wu = _inputs(card, 1, [(M, D), (D, F), (D, F)], dtype, scales=[1.0, D ** -0.5, D ** -0.5])
    before = SWIGLU_LIBRARY.launches
    out = swiglu_matmul(x, wg, wu)
    assert SWIGLU_LIBRARY.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), swiglu_ref(x, wg, wu).float(),
                               atol=_tol(dtype, 1e-4, 5e-2), rtol=2e-2)


@pytest.mark.parametrize("D,F", [(256, 96), (2056, 200)])
@pytest.mark.parametrize("M", [1, 8, 15, 16, 63, 64, 79, 996])
def test_swiglu_tensor_core_variants(card, M, D, F):
    """bf16 through the variant the selector picks (decode below 64 rows,
    wgmma from 64): a K tail (D = 2056 is not a multiple of the 64- or
    32-row K tiles) and F not a multiple of the column tiles."""
    variant = select_swiglu_variant(M, D, F, torch.bfloat16)
    assert variant == ("wgmma" if M >= 64 else "decode")
    x, wg, wu = _inputs(card, 7, [(M, D), (D, F), (D, F)], torch.bfloat16,
                        scales=[1.0, D ** -0.5, D ** -0.5])
    before = dict(SWIGLU_LIBRARY.counts)
    out = swiglu_matmul(x, wg, wu)
    assert SWIGLU_LIBRARY.counts[variant] == before[variant] + 1
    assert SWIGLU_LIBRARY.launches == sum(before.values()) + 1
    torch.testing.assert_close(out.float(), swiglu_ref(x, wg, wu).float(), atol=5e-2, rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D", [(100, 100, 64), (996, 996, 64), (100, 130, 64),
                                     (130, 100, 64), (100, 100, 128), (996, 996, 128),
                                     (100, 130, 128), (130, 100, 128), (200, 200, 16),
                                     (200, 200, 48)])
def test_flash_tensor_core_variant(card, causal, Sq, Sk, D):
    """bf16 through the mma.sync kernel: ragged S, Sq != Sk both ways, head
    dims 16 to 128 (padded in shared memory), causal and not."""
    assert select_flash_variant(D, D, torch.bfloat16) == "mma"
    q, k, v = _inputs(card, 8, [(2, Sq, D), (2, Sk, D), (2, Sk, D)], torch.bfloat16)
    before = FLASH_LIBRARY.counts["mma"]
    out = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.counts["mma"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(100, 100, 192, 128), (1024, 1024, 192, 128),
                                        (100, 130, 192, 128), (130, 100, 192, 128),
                                        (200, 200, 64, 32), (77, 77, 32, 128),
                                        (150, 150, 176, 48), (96, 96, 40, 24)])
def test_flash_value_head_dim(card, dtype, causal, Sq, Sk, D, Dv):
    """v [BH, Sk, Dv] with Dv != D through the variant the selector picks
    (MLA's 192/128 on the 192/128 mma tile, other pairs on smaller tiles,
    40/24 and f32 on the CUDA cores): ragged S, Sq != Sk both ways, causal
    and not; MLA's scale (192^-0.5 here as the default)."""
    variant = select_flash_variant(D, Dv, dtype)
    q, k, v = _inputs(card, 11, [(3, Sq, D), (3, Sk, D), (3, Sk, Dv)], dtype)
    before = dict(FLASH_LIBRARY.counts)
    out = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.counts[variant] == before[variant] + 1
    assert FLASH_LIBRARY.launches == sum(before.values()) + 1
    assert out.shape == (3, Sq, Dv) and out.dtype == dtype
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype, 2e-5, 3e-2), rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,D,F", [(64, 120, 2048, 1408), (64, 8, 2048, 1408),
                                     (5, 64, 256, 96), (5, 79, 2056, 200), (3, 63, 256, 96),
                                     (4, 1, 256, 96), (1, 200, 256, 96), (1, 8, 256, 96),
                                     (3, 7, 100, 70), (3, 24, 256, 96), (64, 48, 2048, 1408)])
def test_swiglu_experts_kernel(card, dtype, E, M, D, F):
    """x [E, M, D], wg, wu [E, D, F] through the expert entry the selector
    picks (bf16: decode below 64 rows an expert, in 1, 2 or 4 row tiles of
    16, wgmma from 64; f32 and unaligned D/F: the CUDA cores):
    DeepSeek-V2-Lite's path shapes (120, 48 and 8 rows),
    ragged M (79 and 63 rows do not fill a tile; a tile past an expert's rows
    must not read or write the next expert's), a K tail (D = 2056), F not a
    multiple of the column tiles, one row, and E = 1."""
    variant = select_experts_variant(M, D, F, dtype)
    x, wg, wu = _inputs(card, 12, [(E, M, D), (E, D, F), (E, D, F)], dtype,
                        scales=[1.0, D ** -0.5, D ** -0.5])
    before = dict(SWIGLU_LIBRARY.counts)
    out = swiglu_experts(x, wg, wu)
    assert SWIGLU_LIBRARY.counts[variant] == before[variant] + 1
    assert SWIGLU_LIBRARY.launches == sum(before.values()) + 1
    assert out.shape == (E, M, F) and out.dtype == dtype
    torch.testing.assert_close(out.float(), swiglu_experts_ref(x, wg, wu).float(),
                               atol=_tol(dtype, 1e-4, 5e-2), rtol=2e-2)
    if E > 1:  # each expert equals the one-product kernel on its own slice
        one = swiglu_matmul(x[1].contiguous(), wg[1].contiguous(), wu[1].contiguous())
        torch.testing.assert_close(out[1].float(), one.float(), atol=_tol(dtype, 1e-4, 5e-2),
                                   rtol=2e-2)


@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_mla_model_on_card(card, impl):
    """A narrow DeepSeek-shaped model (MLA at the real head dims 128 + 64 and
    128, 8 experts with a shared expert, a dense lead layer) in bf16:
    prefill and a decode tick with per-slot positions on the card, through
    flash ``mma`` at 192/128 and the expert kernels, against the same model
    on the CPU (the plain versions); logits within 5e-2 of their largest
    magnitude (the bf16 tolerance of ``tests/test_torch_serve.py``).  Every
    token takes all 8 experts (top_k = E, capacity 1.25 tokens a slot: no
    drops), so the output is continuous in the router's logits: with top-2,
    a near tie that bf16 rounding resolves one way on the card and the other
    way on the CPU moved 4 of 153,600 logits past the tolerance (one token;
    H100)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLASpec
    from repro_torch.models import decode_step, forward, init_cache, init_params

    base = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(
        base, n_layers=3, d_model=256, n_heads=2, vocab=512,
        mla=MLASpec(kv_lora_rank=64, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=8, d_ff_expert=96, n_shared=1,
                                router_chunk=64))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():  # scores of order one (see chip_smoke.py)
        for block in model.layers:
            block.attn["wq"].mul_((cfg.n_heads / cfg.d_model) ** 0.5)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 150)))
    step = toks[:, :1]
    outs = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        cache = init_cache(cfg, 2, 160, device=dev)
        logits, cache = forward(m, cfg, {"tokens": toks.to(dev)}, mode="prefill", cache=cache,
                                moe_impl=impl)
        cache["pos"] = torch.tensor([150, 97], device=dev)
        tick, _ = decode_step(m, cfg, cache, step.to(dev), moe_impl=impl)
        outs[dev] = (logits.float().cpu(), tick.float().cpu())
        if dev == "cuda":
            assert FLASH_LIBRARY.counts["mma"] > 0 and SWIGLU_LIBRARY.counts["experts_wgmma"] > 0
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl", ["einsum", "scatter"])
def test_moe_layer_drops_on_card(card, impl, dtype):
    """One MoE layer routed top-2 of 8 experts (a shared expert beside them)
    over chunks of 64 tokens, S = 100 (a full chunk and a padded one), on
    the card through the expert kernels against the same layer on the CPU
    (the plain versions; ``tests/test_torch_moe.py`` holds those to the
    reference), output within 1e-4 (f32) / 5e-2 (bf16) of its largest
    magnitude.  x[..., 0] = 4 and a router biased toward expert 0 make
    every token pick it with a margin far above rounding, so its 20 slots
    overflow and the later tokens are dropped (asserted); the second choice
    is the router's own."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, layers

    base = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(
        base, n_layers=2, d_model=256, vocab=512,
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2, d_ff_expert=96, n_shared=1,
                                router_chunk=64))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
    p = model.layers[1].moe
    with torch.no_grad():
        p["router"][0, 0] = 10.0
    (x,) = _inputs("cpu", 13, [(2, 100, cfg.d_model)], dtype)
    x[..., 0] = 4.0
    _, idx = layers.moe_route(p, cfg.moe, x[:, :64])
    C = layers.moe_capacity(cfg.moe, 64)
    assert ((idx == 0).sum(dim=(1, 2)) > C).all()  # drops in each sequence's first chunk
    want = layers.moe_layer(p, cfg, x, impl=impl).float()
    before = dict(SWIGLU_LIBRARY.counts)
    got = layers.moe_layer(p.to(card), cfg, x.to(card), impl=impl).float().cpu()
    experts = select_experts_variant(4 * C, cfg.d_model, cfg.moe.d_ff_expert, dtype)  # G = 4
    assert SWIGLU_LIBRARY.counts[experts] == before[experts] + 1
    torch.testing.assert_close(got, want, rtol=0,
                               atol=_tol(dtype, 1e-4, 5e-2) * float(want.abs().max()))


def _ssd_inputs(card, seed, BH, S, P, N, dtype, dt_shift=0.0):
    """x, dt = softplus(normal - dt_shift), A = -exp(normal / 2), B and C at
    0.5, as ``tests/test_kernels.py`` draws them (dt_shift 0).  At dt_shift 4
    (dt ~0.02) a chunk of 64 positions decays by 0.1-0.4 instead of ~e^-50,
    so the state carried across chunks counts."""
    rng = np.random.default_rng(seed)
    x, B, C = _inputs(card, seed, [(BH, S, P), (BH, S, N), (BH, S, N)], dtype,
                      scales=[1.0, 0.5, 0.5])
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((BH, S)) - dt_shift)
                          .astype(np.float32))
    A = torch.from_numpy(-np.exp(rng.standard_normal(BH) * 0.5).astype(np.float32))
    return x, dt.to(card), A.to(card), B, C


def _ssd_close(out, ref):
    """Element by element, against the sequential recurrence: y to
    1e-4·max(|ref|, 1), plus one bf16 ulp (2**-7·|ref|) when it is rounded to
    bf16; the f32 final state to 1e-4·max(|ref|, 1)."""
    scale = max(float(ref.float().abs().max()), 1.0)
    rtol = 2.0 ** -7 if out.dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), ref.float(), atol=1e-4 * scale, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,P,N", [(2, 128, 32, 64), (3, 256, 64, 128), (2, 128, 64, 32),
                                      (1, 64, 16, 16), (2, 100, 64, 128), (1, 37, 24, 8)])
def test_ssd_scan_kernel(card, dtype, BH, S, P, N):
    """y and the final state against the sequential recurrence; ragged S and P."""
    x, dt, A, B, C = _ssd_inputs(card, 4, BH, S, P, N, dtype)
    before = SSD_LIBRARY.launches
    y, h = ssd_scan(x, dt, A, B, C, return_state=True)
    assert SSD_LIBRARY.launches == before + 1
    ry, rh = ssd_scan_ref(x, dt, A, B, C, return_state=True)
    assert y.dtype == dtype and h.dtype == torch.float32
    _ssd_close(y, ry)
    _ssd_close(h, rh)
    torch.testing.assert_close(ssd_scan(x, dt, A, B, C), y, atol=0, rtol=0)


@pytest.mark.parametrize("BH,S,P,N", [(2, 100, 64, 128), (3, 256, 64, 128), (1, 37, 64, 16),
                                      (2, 64, 64, 64), (1, 1, 64, 128), (2, 1000, 64, 128),
                                      (2, 130, 64, 48), (1, 200, 64, 80)])
def test_ssd_scan_wgmma(card, BH, S, P, N):
    """bf16 through the tensor-core variant: ragged S, a single position,
    state widths 16 to 128 (48 and 80 fill part of a 64-column tile); y and
    the final state against the sequential recurrence."""
    assert select_ssd_variant(P, N, torch.bfloat16) == "wgmma"
    x, dt, A, B, C = _ssd_inputs(card, 4, BH, S, P, N, torch.bfloat16)
    before = dict(SSD_LIBRARY.counts)
    y, h = ssd_scan(x, dt, A, B, C, return_state=True)
    assert SSD_LIBRARY.counts["wgmma"] == before["wgmma"] + 1
    assert SSD_LIBRARY.counts["cuda_core"] == before["cuda_core"]
    ry, rh = ssd_scan_ref(x, dt, A, B, C, return_state=True)
    assert y.shape == (BH, S, P) and h.shape == (BH, P, N) and h.dtype == torch.float32
    _ssd_close(y, ry)
    _ssd_close(h, rh)
    torch.testing.assert_close(ssd_scan(x, dt, A, B, C), y, atol=0, rtol=0)


@pytest.mark.parametrize("dtype,N", [(torch.bfloat16, 128), (torch.bfloat16, 16),
                                     (torch.float32, 128)])
@pytest.mark.parametrize("S", [300, 1000])
def test_ssd_scan_slow_decay(card, dtype, N, S):
    """Both variants where the carried state counts (dt ~0.02)."""
    x, dt, A, B, C = _ssd_inputs(card, 10, 2, S, 64, N, dtype, dt_shift=4.0)
    variant = select_ssd_variant(64, N, dtype)
    before = SSD_LIBRARY.counts[variant]
    y, h = ssd_scan(x, dt, A, B, C, return_state=True)
    assert SSD_LIBRARY.counts[variant] == before + 1
    ry, rh = ssd_scan_ref(x, dt, A, B, C, return_state=True)
    _ssd_close(y, ry)
    _ssd_close(h, rh)


@pytest.mark.parametrize("N", [128, 16])
def test_ssd_mixer_strided_groups(card, N):
    """The mixer's own layout on the card: x, B and C as strided views of
    one conv-output buffer [B, S, H·P + 2·G·N], two groups for eight heads;
    one wgmma launch, equal to the CPU mixer (the plain version on broadcast
    copies)."""
    Bsz, S, H, G, P = 2, 150, 8, 2, 64
    rng = np.random.default_rng(9)
    buf = torch.from_numpy((rng.standard_normal((Bsz, S, H * P + 2 * G * N)) * 0.5)
                           .astype(np.float32)).to(card, torch.bfloat16)
    x = buf[..., :H * P].reshape(Bsz, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)))
                          .astype(np.float32)).to(card)
    A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)).to(card)
    before = dict(SSD_LIBRARY.counts)
    y, h = ssd_mixer(x, dt, A, Bm, Cm, return_state=True)
    assert SSD_LIBRARY.counts["wgmma"] == before["wgmma"] + 1
    assert SSD_LIBRARY.launches == sum(before.values()) + 1
    ry, rh = ssd_mixer(*(t.cpu() for t in (x, dt, A, Bm, Cm)), return_state=True)
    _ssd_close(y.cpu(), ry)
    _ssd_close(h.cpu(), rh)


def test_ssd_shapes_no_variant_takes_raise(card):
    """A state wider than 128 in bf16 goes to the CUDA-core variant, which
    refuses it: the call raises and nothing is launched."""
    x, dt, A, B, C = _ssd_inputs(card, 6, 1, 8, 64, 256, torch.bfloat16)
    assert select_ssd_variant(64, 256, torch.bfloat16) == "cuda_core"
    before = SSD_LIBRARY.launches
    with pytest.raises(ValueError, match="state width"):
        ssd_scan(x, dt, A, B, C)
    assert SSD_LIBRARY.launches == before


def test_wrappers_launch_on_card(card):
    q, k, v = _inputs(card, 2, [(1, 40, 8, 16), (1, 40, 2, 16), (1, 40, 2, 16)], torch.float32)
    before = FLASH_LIBRARY.launches
    out = gqa_flash_attention(q, k, v, block_q=32, block_k=16)
    assert FLASH_LIBRARY.launches == before + 1
    cpu = gqa_flash_attention(q.cpu(), k.cpu(), v.cpu(), block_q=32, block_k=16)
    torch.testing.assert_close(out.cpu(), cpu, atol=2e-5, rtol=1e-2)
    x, wg, wu = _inputs(card, 3, [(2, 24, 64), (64, 128), (64, 128)], torch.float32,
                        scales=[1.0, 1 / 8, 1 / 8])
    before = SWIGLU_LIBRARY.launches
    out = fused_swiglu(x, wg, wu, block_m=32)
    assert SWIGLU_LIBRARY.launches == before + 1
    torch.testing.assert_close(out.cpu(), fused_swiglu(x.cpu(), wg.cpu(), wu.cpu(), block_m=32),
                               atol=1e-4, rtol=2e-2)
    x, dt, _, Bm, Cm = _ssd_inputs(card, 5, 2, 40, 4 * 16, 2 * 32, torch.float32)
    x, dt = x.reshape(2, 40, 4, 16), dt[:, :, None].expand(2, 40, 4).contiguous()
    Bm, Cm = Bm.reshape(2, 40, 2, 32), Cm.reshape(2, 40, 2, 32)
    A = -torch.linspace(0.5, 2.0, 4, device=card)
    before = SSD_LIBRARY.launches
    y, h = ssd_mixer(x, dt, A, Bm, Cm, return_state=True)
    assert SSD_LIBRARY.launches == before + 1
    ry, rh = ssd_mixer(*(t.cpu() for t in (x, dt, A, Bm, Cm)), return_state=True)
    _ssd_close(y.cpu(), ry)
    _ssd_close(h.cpu(), rh)


def test_mixed_devices_raise(card):
    q = torch.zeros((1, 8, 16), device=card)
    with pytest.raises(ValueError, match="mixed dtypes|operands on"):
        flash_attention(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q)
    x, dt, A, B, C = _ssd_inputs(card, 6, 1, 8, 16, 16, torch.float32)
    with pytest.raises(ValueError, match="mixed dtypes"):
        ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="not supported"):
        ssd_scan(x, dt.double(), A.double(), B, C)


# --------------------------------------------------------------------------- #
# the hybrid, encoder, VLM and Arctic paths' shapes
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Sq,Sk", [(100, 100), (1500, 1500), (77, 130), (130, 77), (1, 100)])
def test_flash_head_dim_80(card, causal, Sq, Sk):
    """HuBERT's head dim 80 in bf16 through the mma kernel (its 128-wide
    tile, loads masked past 80): ragged S, Sq != Sk both ways, one query,
    non-causal (the encoder's) and causal."""
    assert select_flash_variant(80, 80, torch.bfloat16) == "mma"
    q, k, v = _inputs(card, 14, [(4, Sq, 80), (4, Sk, 80), (4, Sk, 80)], torch.bfloat16)
    before = FLASH_LIBRARY.counts["mma"]
    out = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.counts["mma"] == before + 1
    torch.testing.assert_close(out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
                               atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [37, 300])
def test_encoder_attention_on_card(card, dtype, S):
    """A non-causal GQA layer (``layers.attention_full`` and
    ``attention_prefill`` of a HuBERT-shaped config: 4 heads of 80 on 2 kv
    heads, no rope) on the card through the non-causal entry, against the
    same layer on the CPU (the plain version); the causal route differs."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = dataclasses.replace(get_config("hubert-xlarge"), d_model=256, n_heads=4,
                              n_kv_heads=2, head_dim=80)
    rng = np.random.default_rng(15)
    p = {n: torch.from_numpy((rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)).to(dtype)
         for n, s in (("wq", (256, 4, 80)), ("wk", (256, 2, 80)), ("wv", (256, 2, 80)),
                      ("wo", (4, 80, 256)))}
    (x,) = _inputs("cpu", 16, [(2, S, 256)], dtype)
    want = layers.attention_full(p, cfg, x).float()
    pc = {n: t.to(card) for n, t in p.items()}
    before = FLASH_LIBRARY.launches
    got = layers.attention_full(pc, cfg, x.to(card)).float().cpu()
    cache = {n: torch.zeros((2, S + 3, 2, 80), dtype=torch.bfloat16, device=card)
             for n in ("k", "v")}
    pre, cache = layers.attention_prefill(pc, cfg, x.to(card), cache)
    assert FLASH_LIBRARY.launches == before + 2
    tol = _tol(dtype, 1e-4, 5e-2) * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    torch.testing.assert_close(pre.float().cpu(), want, rtol=0, atol=tol)
    assert not bool(cache["k"][:, S:].any())
    causal = layers.attention_full(p, dataclasses.replace(cfg, causal=True), x).float()
    assert float((causal - want).abs().max()) > 10 * tol


def _card_randn(card, seed, shape, dtype, scale=1.0):
    """Normals drawn on the card (the path's expert weights are too large to
    draw on the host)."""
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=card).mul_(scale).to(dtype)


@pytest.mark.parametrize("E,M,D,F", [(16, 160, 4096, 14336), (16, 8, 4096, 14336),
                                     (16, 100, 4096, 14336), (128, 20, 7168, 4864),
                                     (128, 8, 7168, 4864)])
def test_swiglu_experts_path_shapes(card, E, M, D, F):
    """The expert entries at Jamba's experts (16 of D 4096, F 14336: a
    prefill's capacity of 160 rows, a shorter prompt's 100, a tick's 8) and
    Arctic's (128 of D 7168, F 4864: 20 rows, 8), bf16, against the plain
    version on the card."""
    variant = select_experts_variant(M, D, F, torch.bfloat16)
    assert variant == ("experts_wgmma" if M >= 64 else "experts_decode")
    x = _card_randn(card, 17, (E, M, D), torch.bfloat16)
    wg = _card_randn(card, 18, (E, D, F), torch.bfloat16, D ** -0.5)
    wu = _card_randn(card, 19, (E, D, F), torch.bfloat16, D ** -0.5)
    before = dict(SWIGLU_LIBRARY.counts)
    out = swiglu_experts(x, wg, wu)
    assert SWIGLU_LIBRARY.counts[variant] == before[variant] + 1
    torch.testing.assert_close(out.float(), swiglu_experts_ref(x, wg, wu).float(), atol=5e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("Bsz,S", [(1, 300), (2, 1000), (1, 1)])
def test_ssd_mixer_jamba_layout(card, Bsz, S):
    """The SSD scan on Jamba's mixer layout: x, B and C as views of one conv
    output [B, S, 8192 + 2·16] (row stride 8224, C from element 8208), 128
    heads of 64, state width 16, one group; one wgmma launch, equal to the
    CPU mixer (the plain version)."""
    H, G, P, N = 128, 1, 64, 16
    rng = np.random.default_rng(20)
    buf = torch.from_numpy((rng.standard_normal((Bsz, S, H * P + 2 * G * N)) * 0.5)
                           .astype(np.float32)).to(card, torch.bfloat16)
    x = buf[..., :H * P].reshape(Bsz, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
    assert buf.stride(1) == 8224 and Cm.data_ptr() - x.data_ptr() == 2 * 8208
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)) - 4.0)
                          .astype(np.float32)).to(card)
    A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)).to(card)
    before = dict(SSD_LIBRARY.counts)
    y, h = ssd_mixer(x, dt, A, Bm, Cm, return_state=True)
    assert SSD_LIBRARY.counts["wgmma"] == before["wgmma"] + 1
    assert SSD_LIBRARY.launches == sum(before.values()) + 1
    ry, rh = ssd_mixer(*(t.cpu() for t in (x, dt, A, Bm, Cm)), return_state=True)
    _ssd_close(y.cpu(), ry)
    _ssd_close(h.cpu(), rh)


def test_hybrid_model_on_card(card):
    """A narrow Jamba-shaped model (one super period of 4: mamba2 mixers at
    the SSD kernel's shapes, head dim 64 and state 16, attention at position
    1, 4 experts at the odd positions) in bf16: prefill and a decode tick
    with per-slot positions on the card, through flash ``mma``, the SSD
    ``wgmma`` scan, the dense and expert SwiGLU kernels, against the same
    model on the CPU (the plain versions); logits within 5e-2 of their
    largest magnitude.  Every token takes all 4 experts (top_k = E, no
    drops), so the output is continuous in the router (see
    ``test_moe_mla_model_on_card``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import HybridSpec, SSMSpec
    from repro_torch.models import decode_step, forward, init_cache, init_params

    base = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(
        base, n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=192, vocab=512,
        hybrid=HybridSpec(attn_period=4, attn_offset=1),
        ssm=SSMSpec(d_state=16, head_dim=64, expand=2, n_groups=1, conv_width=4, chunk=64),
        moe=dataclasses.replace(base.moe, n_experts=4, top_k=4, d_ff_expert=96, router_chunk=64))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():  # scores of order one (see chip_smoke.py)
        for block in model.layers:
            if hasattr(block, "attn"):
                for n in ("wq", "wk", "wv"):
                    block.attn[n].mul_((block.attn[n].shape[1] / cfg.d_model) ** 0.5)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 150)))
    outs = {}
    for dev in ("cpu", "cuda"):
        m = model.to(dev)
        before = {lib.name: dict(lib.counts) for lib in (FLASH_LIBRARY, SSD_LIBRARY,
                                                         SWIGLU_LIBRARY)}
        cache = init_cache(cfg, 2, 160, device=dev)
        logits, cache = forward(m, cfg, {"tokens": toks.to(dev)}, mode="prefill", cache=cache)
        cache["pos"] = torch.tensor([150, 97], device=dev)
        tick, _ = decode_step(m, cfg, cache, toks[:, :1].to(dev))
        outs[dev] = (logits.float().cpu(), tick.float().cpu())
        if dev == "cuda":
            assert FLASH_LIBRARY.counts["mma"] == before["flash_attention"]["mma"] + 1
            assert SSD_LIBRARY.counts["wgmma"] == before["ssd_scan"]["wgmma"] + 3
            assert SWIGLU_LIBRARY.counts["experts_wgmma"] > before["swiglu_matmul"]["experts_wgmma"]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=5e-2 * float(want.abs().max()))


# --------------------------------------------------------------------------- #
# the CNN pipeline's MPMD executor: m workers as m CUDA streams
# --------------------------------------------------------------------------- #
@pytest.fixture
def f32_card(card):
    """The card with TF32 off in cuDNN and cuBLAS (f32 parity), restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield card
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _cnn_case(sliced: bool, m: int):
    """inception_net(32), whole or grid-sliced, its DSH plan on m workers,
    seeded weights (f32 on the card) and a batch-2 input; the reference is
    the port's own run_sequential on the CPU in float64."""
    from repro_torch.codegen import build_plan
    from repro_torch.core import dsh
    from repro_torch.core.costmodel import KEYSTONE_CPU
    from repro_torch.models.cnn import inception_net, run_sequential
    from repro_torch.models.slicing import choose_slice_factors, slice_model

    model = inception_net(32)
    params = model.init_params(0, device="cpu")
    if sliced:
        model = slice_model(model, choose_slice_factors(model, KEYSTONE_CPU))
    dag = model.to_dag(KEYSTONE_CPU, time_unit=1e-6)
    plan = build_plan(dsh(dag, m), dag)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32))
    ref = run_sequential(model, {k: {n: t.double() for n, t in d.items()} for k, d in params.items()},
                         x.double())
    return model, plan, params, x, ref


def _cnn_close(out, ref):
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    err = float((out.cpu().double() - ref).abs().max())
    assert err <= tol, f"max abs error {err:.3g} > {tol:.3g}"


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("m", [2, 4])
def test_mpmd_executor_on_streams(f32_card, m, sliced, fuse):
    """Eager and captured, the executor on m streams gives the float64
    sequential result, copies executed_comm_bytes between workers, and
    replays bit for bit what its eager run gives."""
    from repro_torch.codegen import build_mpmd_executor, executed_comm_bytes
    from repro_torch.kernels import LIBRARIES

    model, plan, params, x, ref = _cnn_case(sliced, m)
    dparams = {k: {n: t.to(f32_card) for n, t in d.items()} for k, d in params.items()}
    f = build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2, fuse_transfers=fuse)
    xd = x.to(f32_card)
    before = [dict(lib.counts) for lib in LIBRARIES]
    eager = f.eager(xd)
    torch.cuda.synchronize()
    _cnn_close(eager, ref)
    assert len(f.streams_used) == m == len({s.cuda_stream for s in f.streams})
    assert f.comm_bytes == executed_comm_bytes(plan, model, batch=2, fuse_transfers=fuse)
    first = f(xd)
    second = f(xd)
    torch.cuda.synchronize()
    _cnn_close(first, ref)
    assert torch.equal(first, second) and torch.equal(first, eager)
    assert [dict(lib.counts) for lib in LIBRARIES] == before  # no Hopper kernel on this path


def test_mpmd_executor_replays_new_inputs(f32_card):
    """The captured graph reads each call's input: a second input gives its
    own result, equal bit for bit to the eager run on it."""
    from repro_torch.codegen import build_mpmd_executor

    model, plan, params, x, _ref = _cnn_case(True, 4)
    dparams = {k: {n: t.to(f32_card) for n, t in d.items()} for k, d in params.items()}
    f = build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2)
    a = f(x.to(f32_card))
    x2 = (x * 0.5 + 1.0).to(f32_card)
    b = f(x2)
    assert not torch.equal(a, b)
    assert torch.equal(b, f.eager(x2))
    with pytest.raises(ValueError, match="batch=2"):
        f(x2[:1])


# --------------------------------------------------------------------------- #
# the segmented executor: packed carries on m CUDA streams
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("checkpoint", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("m", [2, 4])
def test_segmented_executor_on_streams(f32_card, m, depth, checkpoint):
    """Eager and captured, the segmented executor on m streams gives the
    float64 sequential result, bit for bit the same at every depth and in
    both modes, on a second input too (the carry persists at depth >= 2),
    with its real comm bytes equal to executed_comm_bytes."""
    from repro_torch.codegen import build_mpmd_executor, executed_comm_bytes
    from repro_torch.kernels import LIBRARIES

    model, plan, params, x, ref = _cnn_case(True, m)
    dparams = {k: {n: t.to(f32_card) for n, t in d.items()} for k, d in params.items()}
    xd, x2 = x.to(f32_card), x.flip(0).to(f32_card)
    before = [dict(lib.counts) for lib in LIBRARIES]
    outs = {}
    for d in sorted({1, depth}):
        f = build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2, segmented=True,
                                buffer_depth=d, checkpoint=checkpoint)
        def out(r):
            return r[0] if checkpoint else r

        eager = out(f.eager(xd))
        torch.cuda.synchronize()
        assert f.streams_used == {s.cuda_stream for s in f.streams} and len(f.streams_used) == m
        assert f.comm_real_bytes == executed_comm_bytes(plan, model, batch=2, segmented=True,
                                                        buffer_depth=d)
        first, second, other = out(f(xd)), out(f(x2)), out(f(xd))
        torch.cuda.synchronize()
        _cnn_close(first, ref)
        _cnn_close(second, ref.flip(0))
        assert torch.equal(first, eager) and torch.equal(first, other)
        outs[d] = first
    assert torch.equal(outs[1], outs[depth])
    assert [dict(lib.counts) for lib in LIBRARIES] == before  # no Hopper kernel on this path


def test_segmented_landing_waits_for_its_sender(f32_card):
    """Planted fault: sender 0 is held back ~10 ms before each gather.  With
    its landings waiting on the sender's flag the result is right; with the
    wait dropped the landing copies the payload before the gather wrote
    it, and the result is wrong — the events, not issue order, keep a
    landing after its sender's gather."""
    from repro_torch.codegen import build_mpmd_executor

    model, plan, params, x, _ref = _cnn_case(True, 4)
    dparams = {k: {n: t.to(f32_card) for n, t in d.items()} for k, d in params.items()}
    xd = (x * 0.5 + 1.0).to(f32_card)

    def slowed(f):
        gather = f._gather_payload

        def delayed(s, row):
            if s == 0:
                torch.cuda._sleep(20_000_000)
            return gather(s, row)
        f._gather_payload = delayed
        return f

    planted = slowed(build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2,
                                         segmented=True))
    planted._workers.wait = lambda w, flag: None
    wrong = planted.eager(xd)
    torch.cuda.synchronize()
    right = slowed(build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2,
                                       segmented=True)).eager(xd)
    torch.cuda.synchronize()
    plain = build_mpmd_executor(plan, model, dparams, device=f32_card, batch=2,
                                segmented=True).eager(xd)
    assert torch.equal(right, plain)
    assert not torch.equal(wrong, plain)


# --------------------------------------------------------------------------- #
# training: the kernels' gradient paths (explicit VJPs in PyTorch)
# --------------------------------------------------------------------------- #
# Each kernel's VJP against autograd through its plain version.  The VJPs
# run in f32 from the kernels' outputs (flash: bf16 o in rowsum(dO ⊙ O);
# SwiGLU: g and u recomputed by bf16 products, dg and du rounded to bf16
# before theirs), autograd through the plain versions in f32 throughout, and
# both round the gradients to the inputs' dtype: bf16 gradients agree to
# 3e-2 of their largest magnitude, f32 ones to 1e-4.  A VJP without its
# causal mask, or with σ(g) in place of silu'(g), misses by O(1) of it
# (test_vjp_planted_faults_break_the_bounds below, on the CPU).
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


def _grads_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=GRAD_TOL[dtype] * float(w.float().abs().max()))


def _leaves(card, seed, shapes, dtype, scales=None):
    return [t.requires_grad_(True) for t in _inputs(card, seed, shapes, dtype, scales)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(100, 100, 64, 64), (1024, 1024, 64, 64),
                                        (130, 100, 64, 64), (100, 130, 80, 80),
                                        (150, 150, 128, 128), (100, 100, 192, 128),
                                        (256, 256, 192, 128)])
def test_flash_vjp_on_card(card, dtype, causal, Sq, Sk, D, Dv):
    """The kernel's output has a ``grad_fn`` and its gradients equal
    autograd through the plain version: ragged S, Sq != Sk both ways, D 64,
    80, 128 and MLA's 192/128, causal and not."""
    q, k, v = _leaves(card, 21, [(4, Sq, D), (4, Sk, D), (4, Sk, Dv)], dtype)
    (do,) = _inputs(card, 22, [(4, Sq, Dv)], dtype)
    before = FLASH_LIBRARY.launches
    o = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.launches == before + 1 and o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, causal=causal), (q, k, v), do)
    # bf16: the backward launches wgmma_bwd; f32: its VJP is PyTorch
    assert FLASH_LIBRARY.launches == before + (2 if dtype == torch.bfloat16 else 1)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(8, 256, 96), (200, 256, 96), (5, 100, 70),
                                   (4096, 2048, 512)])
def test_swiglu_vjp_on_card(card, dtype, M, D, F):
    """Through each variant (decode, wgmma, cuda_core; f32 all cuda_core)."""
    x, wg, wu = _leaves(card, 23, [(M, D), (D, F), (D, F)], dtype,
                        scales=[1.0, D ** -0.5, D ** -0.5])
    (dout,) = _inputs(card, 24, [(M, F)], dtype)
    out = swiglu_matmul(x, wg, wu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (x, wg, wu), dout)
    want = torch.autograd.grad(swiglu_ref(x, wg, wu), (x, wg, wu), dout)
    _grads_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,M,D,F", [(5, 64, 256, 96), (3, 24, 256, 96), (3, 7, 100, 70),
                                     (4, 120, 2048, 1408)])
def test_swiglu_experts_vjp_on_card(card, dtype, E, M, D, F):
    x, wg, wu = _leaves(card, 25, [(E, M, D), (E, D, F), (E, D, F)], dtype,
                        scales=[1.0, D ** -0.5, D ** -0.5])
    (dout,) = _inputs(card, 26, [(E, M, F)], dtype)
    out = swiglu_experts(x, wg, wu)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (x, wg, wu), dout)
    want = torch.autograd.grad(swiglu_experts_ref(x, wg, wu), (x, wg, wu), dout)
    _grads_close(got, want, dtype)


# --------------------------------------------------------------------------- #
# the backward kernels against their plain versions, and run against run
# --------------------------------------------------------------------------- #
# Each kernel against its plain version from the same inputs (flash: the
# kernel's own o and lse): both compute in f32; the kernels round P and dS
# (flash) to bf16 for their products, and every gradient is rounded to bf16.
# Within 3e-2 of each gradient's largest magnitude, as the VJPs above.
BWD_TOL = 3e-2


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(100, 100, 32, 32), (128, 128, 64, 64),
                                        (1024, 1024, 64, 64), (100, 130, 64, 64),
                                        (130, 100, 64, 64), (1, 100, 64, 64),
                                        (100, 100, 80, 80), (77, 130, 80, 80),
                                        (150, 150, 128, 128), (300, 300, 128, 128),
                                        (100, 100, 192, 128), (256, 256, 192, 128),
                                        (130, 100, 192, 128), (64, 64, 16, 16),
                                        (200, 260, 48, 48), (130, 130, 96, 96),
                                        (300, 300, 64, 128), (100, 100, 160, 128),
                                        (600, 600, 80, 80)])
def test_flash_wgmma_bwd(card, causal, Sq, Sk, D, Dv):
    """``wgmma_bwd`` at every tile class (64/64, which D 16 to 64 zero-fill,
    80/80, 128/128, 192/128) and head dims that fill a class partly or
    differ (D 64, Dv 128), ragged S, several key and query tiles, Sq != Sk
    both ways (rows that see no key): dq, dk, dv against
    ``flash_attention_bwd_ref`` from the forward kernel's o and lse (lse
    against the plain version's to 1e-4), and bit for bit the same over two
    calls."""
    import importlib

    from repro_torch.kernels import flash_attention_bwd_ref

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    q, k, v, do = _inputs(card, 40, [(3, Sq, D), (3, Sk, D), (3, Sk, Dv), (3, Sq, Dv)],
                          torch.bfloat16)
    sc = D ** -0.5
    o, lse = fa._launch(q, k, v, causal, sc, with_lse=True)
    _, want_lse = flash_attention_ref(q, k, v, causal=causal, scale=sc, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    before = dict(FLASH_LIBRARY.counts)
    got = fa._launch_bwd(q, k, v, o, do, lse, causal, sc)
    assert FLASH_LIBRARY.counts["wgmma_bwd"] == before["wgmma_bwd"] + 1
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, sc)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        assert _rel(g, w) <= BWD_TOL, (name, _rel(g, w))
    again = fa._launch_bwd(q, k, v, o, do, lse, causal, sc)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("E,M,D,F", [(None, 8, 256, 96), (None, 200, 256, 96),
                                     (None, 79, 2056, 200), (None, 4096, 2048, 512),
                                     (None, 1, 64, 64), (5, 64, 256, 96), (3, 24, 256, 96),
                                     (4, 120, 2048, 1408), (3, 7, 64, 64),
                                     (4, 1280, 4096, 14336)])
def test_swiglu_wgmma_bwd(card, E, M, D, F):
    """``wgmma_bwd`` and ``experts_wgmma_bwd`` at rows below and above 64,
    ragged M and F tiles, a K tail (D = 2056), DeepSeek's experts and the
    Jamba train period's (4 kept of 16, 1280 rows each): dg and du against
    ``swiglu_bwd_ref`` (the forward's tolerance: 5e-2 + 2e-2·|ref|), and
    bit for bit the same over two calls."""
    import importlib

    from repro_torch.kernels import swiglu_bwd_ref

    sw = importlib.import_module("repro_torch.kernels.swiglu_matmul")
    lead = () if E is None else (E,)
    x, wg, wu, dout = _inputs(card, 41, [(*lead, M, D), (*lead, D, F), (*lead, D, F),
                                         (*lead, M, F)], torch.bfloat16,
                              scales=[1.0, D ** -0.5, D ** -0.5, 1.0])
    variant = "wgmma_bwd" if E is None else "experts_wgmma_bwd"
    before = dict(SWIGLU_LIBRARY.counts)
    got = sw._launch_bwd(x, wg, wu, dout)
    assert SWIGLU_LIBRARY.counts[variant] == before[variant] + 1
    for g, w in zip(got, swiglu_bwd_ref(x, wg, wu, dout)):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), atol=5e-2, rtol=2e-2)
    again = sw._launch_bwd(x, wg, wu, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("H,N,Bsz,S", [(32, 128, 2, 300), (128, 16, 1, 200)])
def test_ssd_vjp_on_card(card, dtype, with_dh, H, N, Bsz, S):
    """The SSD scan's ``autograd.Function`` on the mixer's strided views of
    one conv output, at mamba2's layout (32 heads of 64, state 128) and
    Jamba's (128 heads, state 16), one group, dt ~0.02 (the carry counts):
    bf16 through ``wgmma``, f32 through ``cuda_core`` on flat copies.  The
    gradients of the conv output, dt and A equal autograd through the plain
    version on the card, with a cotangent for the final state and without
    one (a train step discards it); the bf16 backward is one ``wgmma_bwd``
    launch, the f32 one launches no kernel."""
    from repro_torch.kernels.ref import ssd_mixer_ref

    P, G = 64, 1
    rng = np.random.default_rng(28)
    buf = torch.from_numpy((rng.standard_normal((Bsz, S, H * P + 2 * G * N)) * 0.5)
                           .astype(np.float32)).to(card, dtype).requires_grad_(True)
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)) - 4.0)
                          .astype(np.float32)).to(card).requires_grad_(True)
    A = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)).to(
        card).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((Bsz, S, H, P)).astype(np.float32)).to(card, dtype)
    dh = torch.from_numpy(rng.standard_normal((Bsz, H, P, N)).astype(np.float32)).to(card)

    def views():
        return (buf[..., :H * P].reshape(Bsz, S, H, P),
                buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N),
                buf[..., H * P + G * N:].reshape(Bsz, S, G, N))

    def grads(fn):
        x, Bm, Cm = views()
        y, h = fn(x, dt, A, Bm, Cm, return_state=True)
        outs, cots = ([y, h], [dy, dh]) if with_dh else ([y], [dy])
        return y, torch.autograd.grad(outs, (buf, dt, A), cots)

    variant = select_ssd_variant(P, N, dtype)
    assert variant == ("wgmma" if dtype == torch.bfloat16 else "cuda_core")
    before = dict(SSD_LIBRARY.counts)
    y, got = grads(ssd_mixer)
    assert y.grad_fn is not None
    assert SSD_LIBRARY.counts[variant] == before[variant] + 1
    # the bf16 backward is one wgmma_bwd launch; the f32 one (the VJP) launches none
    bwd = dtype == torch.bfloat16
    assert SSD_LIBRARY.counts["wgmma_bwd"] == before["wgmma_bwd"] + bwd
    assert SSD_LIBRARY.launches == sum(before.values()) + 1 + bwd
    _, want = grads(ssd_mixer_ref)
    for name, g, w in zip(("conv output", "dt", "A"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= GRAD_TOL[dtype], (name, err)


# the SSD scan's backward kernel against ssd_scan_vjp on the same inputs,
# per gradient, within this share of its largest magnitude: both compute in
# f32 (the kernel's f32 operands as bf16 hi + lo pairs, ~5e-6 of each
# gradient on the CPU, ref.ssd_scan_bwd_phases), and both round dx, dB and
# dC to bf16 (one ulp, 2**-8 of a value)
SSD_BWD_TOL = 1e-2


def ssd_bwd_case(card, seed, Bsz, S, H, G, N, with_dh, dt_shift):
    """The backward's operands on the mixer's layout: x, B and C strided
    views of one bf16 conv output, dt, A as [B, H], dy (bf16), dh_final (f32
    or None)."""
    P = 64
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy((rng.standard_normal((Bsz, S, H * P + 2 * G * N)) * 0.5)
                           .astype(np.float32)).to(card, torch.bfloat16)
    x = buf[..., :H * P].reshape(Bsz, S, H, P)
    Bm = buf[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    Cm = buf[..., H * P + G * N:].reshape(Bsz, S, G, N)
    dt = torch.from_numpy(np.logaddexp(0.0, rng.standard_normal((Bsz, S, H)) - dt_shift)
                          .astype(np.float32)).to(card)
    A2 = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)).to(
        card)[None].expand(Bsz, H)
    dy = torch.from_numpy(rng.standard_normal((Bsz, S, H, P)).astype(np.float32)).to(
        card, torch.bfloat16)
    dh = (torch.from_numpy(rng.standard_normal((Bsz, H, P, N)).astype(np.float32)).to(card)
          if with_dh else None)
    return x, dt, A2, Bm, Cm, dy, dh


@pytest.mark.parametrize("with_dh", [True, False])
@pytest.mark.parametrize("Bsz,S,H,G,N,dt_shift", [
    (1, 64, 1, 1, 128, 0.0), (2, 100, 4, 2, 128, 4.0), (1, 300, 4, 1, 16, 4.0),
    (2, 1, 2, 1, 128, 4.0), (1, 200, 4, 4, 64, 4.0), (2, 130, 8, 2, 48, 4.0),
    (1, 257, 2, 1, 80, 4.0), (4, 1024, 32, 1, 128, 4.0), (2, 1024, 128, 1, 16, 4.0)])
def test_ssd_wgmma_bwd(card, with_dh, Bsz, S, H, G, N, dt_shift):
    """``wgmma_bwd`` against ``ssd_scan_vjp`` on the same inputs: one
    chunk, ragged S, one position, G 1, 2 and H, state widths 16 to 128
    (48 and 80 fill part of a tile), mamba2's train layout (B 4, S 1024, H
    32, N 128) and Jamba's (H 128, N 16), dt ~0.02 where the carry counts,
    with and without a final-state cotangent; one launch, and bit for bit
    the same over two."""
    import importlib

    ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
    x, dt, A2, Bm, Cm, dy, dh = ssd_bwd_case(card, 42, Bsz, S, H, G, N, with_dh, dt_shift)
    assert ssd.select_bwd_variant(64, N, torch.bfloat16) == "wgmma_bwd"
    before = dict(SSD_LIBRARY.counts)
    got = ssd._launch_bwd(x, dt, A2, Bm, Cm, dy, dh)
    assert SSD_LIBRARY.counts["wgmma_bwd"] == before["wgmma_bwd"] + 1
    assert SSD_LIBRARY.launches == sum(before.values()) + 1
    want = ssd.ssd_scan_vjp(x, dt, A2, Bm, Cm, dy, dh)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.isfinite(g).all(), name
        # one position: A does not reach y, and dA is 0 in both
        err = float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()),
                                                                 1e-30)
        assert err <= SSD_BWD_TOL, (name, err)
    again = ssd._launch_bwd(x, dt, A2, Bm, Cm, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _narrow(arch):
    import dataclasses

    from repro_torch.configs import get_config

    base = get_config(arch)
    if arch == "tinyllama-1.1b":
        return dataclasses.replace(base, n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                                   head_dim=64, d_ff=512, vocab=512)
    if arch == "mamba2-370m":  # 8 heads of 64, state 128: the wgmma scan's shapes
        return dataclasses.replace(base, n_layers=2, d_model=256, vocab=512)
    return dataclasses.replace(  # MLA at its real head dims, 8 experts top-2, a shared one
        base, n_layers=3, d_model=256, n_heads=2, vocab=512,
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=2, d_ff_expert=96, n_shared=1,
                                router_chunk=64))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v2-lite-16b", "mamba2-370m"])
def test_every_parameter_gets_a_gradient_on_card(f32_card, arch):
    """A narrow dense, a narrow MoE and a narrow mamba2 model train one
    backward on the card through the kernels (bf16: every parameter's
    gradient finite and not zero), and in f32 their gradients equal the CPU's (the plain versions)
    to 1e-3 of each leaf's largest magnitude (remat on).  Attention is
    rescaled to its real fan-in first, as ``chip_smoke.py`` does: at the
    reference's scale the scores are a hard argmax, whose near ties the
    card and the CPU may break apart (ROADMAP Queue 3)."""
    from repro_torch.models import init_params
    from repro_torch.train import loss_fn

    cfg = _narrow(arch)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 129)))
    for dtype in (torch.bfloat16, torch.float32):
        model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=dtype)
        with torch.no_grad():
            for block in model.layers:
                for n in ("wq", "wk", "wv", "w_uk", "w_uv"):
                    if n in getattr(block, "attn", {}):
                        w = block.attn[n]
                        fan_in = cfg.d_model if n in ("wq", "wk", "wv") else w.shape[0]
                        w.mul_((w.shape[1] / fan_in) ** 0.5)
        grads = {}
        for dev in (("cuda", "cpu") if dtype == torch.float32 else ("cuda",)):
            m = model.to(dev).requires_grad_(True)
            for p in m.parameters():
                p.grad = None
            before = FLASH_LIBRARY.launches, SSD_LIBRARY.launches
            loss, _ = loss_fn(m, cfg, toks[:, :-1].to(dev), toks[:, 1:].to(dev), remat=True)
            loss.backward()
            if dev == "cuda":  # every layer's kernel launches twice: forward, recompute
                # (bf16: and its backward kernel, wgmma_bwd or the SSD scan's wgmma_bwd)
                n_ssm = cfg.n_layers if cfg.family == "ssm" else 0
                per_layer = 3 if dtype == torch.bfloat16 else 2
                assert FLASH_LIBRARY.launches == before[0] + per_layer * (cfg.n_layers - n_ssm)
                assert SSD_LIBRARY.launches == before[1] + per_layer * n_ssm
            grads[dev] = {n: p.grad.float().cpu() for n, p in m.named_parameters()}
        for name, g in grads["cuda"].items():
            assert torch.isfinite(g).all() and g.abs().max() > 0, (dtype, name)
            if "cpu" in grads:
                want = grads["cpu"][name]
                err = float((g - want).abs().max() / want.abs().max())
                assert err <= 1e-3, (name, err)


# --------------------------------------------------------------------------- #
# the VJP functions themselves, on the CPU (no card needed)
# --------------------------------------------------------------------------- #
# Against autograd through the plain versions, with f64 inputs: the plain
# versions compute in f32 inside, so the two agree to f32 rounding, 1e-5 of
# each gradient's largest magnitude (measured: <= 3e-6).
VJP_TOL = 1e-5


def _f64(seed, shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True) for s in shapes]


def _max_rel(got, want):
    with torch.no_grad():
        return max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,Dv", [(17, 17, 8, 8), (9, 23, 8, 4), (23, 9, 12, 12),
                                        (40, 40, 24, 16)])
def test_flash_vjp_matches_autograd(monkeypatch, causal, Sq, Sk, D, Dv):
    """Over several BH chunks (VJP_CHUNK_ELEMS shrunk), ragged Sq != Sk both
    ways (rows that see no key when Sq > Sk), Dv != D."""
    import importlib

    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    monkeypatch.setattr(fa, "VJP_CHUNK_ELEMS", 2 * Sq * Sk)
    q, k, v = _f64(30, [(5, Sq, D), (5, Sk, D), (5, Sk, Dv)])
    o = flash_attention_ref(q, k, v, causal=causal, scale=0.3)
    (do,) = _f64(31, [tuple(o.shape)])
    want = torch.autograd.grad(o, (q, k, v), do)
    got = fa.flash_attention_vjp(q.detach(), k.detach(), v.detach(), o.detach(), do.detach(),
                                 causal, 0.3)
    assert all(g.dtype == torch.float64 for g in got)
    assert _max_rel(got, want) <= VJP_TOL


@pytest.mark.parametrize("lead", [(), (3,)])
def test_swiglu_vjp_matches_autograd(lead):
    """One product and the expert-batched form (a leading expert dim)."""
    from repro_torch.kernels import swiglu_vjp

    x, wg, wu = _f64(32, [(*lead, 11, 16), (*lead, 16, 12), (*lead, 16, 12)])
    fn = swiglu_experts_ref if lead else swiglu_ref
    out = fn(x, wg, wu)
    (dout,) = _f64(33, [tuple(out.shape)])
    want = torch.autograd.grad(out, (x, wg, wu), dout)
    got = swiglu_vjp(x.detach(), wg.detach(), wu.detach(), dout.detach())
    assert [g.shape for g in got] == [w.shape for w in want]
    assert _max_rel(got, want) <= VJP_TOL


def test_vjp_planted_faults_break_the_bounds():
    """The faults chip_smoke.py plants: the flash VJP without its causal
    mask, and σ(g) in place of silu'(g) in the SwiGLU's, miss the autograd
    gradients by far more than any tolerance here (f32's 1e-4, bf16's
    3e-2)."""
    from repro_torch.kernels import flash_attention_vjp

    q, k, v = _f64(34, [(3, 20, 8), (3, 20, 8), (3, 20, 8)])
    o = flash_attention_ref(q, k, v, causal=True)
    (do,) = _f64(35, [tuple(o.shape)])
    want = torch.autograd.grad(o, (q, k, v), do)
    unmasked = flash_attention_vjp(q.detach(), k.detach(), v.detach(), o.detach(), do, False,
                                   8 ** -0.5)
    assert _max_rel(unmasked, want) > 0.3

    x, wg, wu = _f64(36, [(11, 16), (16, 12), (16, 12)])
    with torch.no_grad():  # weights at the model's scale, D^-0.5: g of order one
        wg.mul_(0.25), wu.mul_(0.25)
    g, u = x.detach() @ wg.detach(), x.detach() @ wu.detach()
    out = swiglu_ref(x, wg, wu)
    (dout,) = _f64(37, [tuple(out.shape)])
    want_dwg = torch.autograd.grad(out, wg, dout)[0]
    fault_dwg = x.detach().T @ (dout * u * torch.sigmoid(g))  # the fault: σ(g) for silu'(g)
    assert float((fault_dwg - want_dwg).abs().max() / want_dwg.abs().max()) > 0.2


ACCOUNTING_FAMILIES = ["tinyllama-1.1b", "deepseek-v2-lite-16b", "mamba2-370m",
                       "jamba-v0.1-52b", "hubert-xlarge", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch,kind", [(a, k) for a in ACCOUNTING_FAMILIES
                                       for k in ("train", "prefill", "decode")
                                       if (a, k) != ("hubert-xlarge", "decode")])
def test_card_count_equals_meta_count(card, arch, kind):
    """The launch accounting of one narrow config of each family: the step
    counted on the card (kernels launched, VJPs in the backward) equals the
    same step counted on ``meta`` (``launch.analysis.count_step``), per aten
    op, per kernel variant and per VJP, launches included; the outputs are
    finite."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import analysis

    cfg = get_config(arch).reduced()
    shape = ShapeSpec("narrow", kind, 96, 2)
    counts = {}
    for device in ("meta", card):
        step, args, _ = analysis.build_cell(cfg, shape, device, microbatches=1,
                                            bf16_moments=False)
        counts[str(device)] = analysis.count_step(step, args)
    meta, got = counts["meta"], counts[str(card)]
    assert got["components"] == meta["components"] and got["kernels"] == meta["kernels"]
    assert got["launches"] == meta["launches"]
    assert sum(n for row in got["launches"].values() for n in row.values()) == sum(
        row["calls"] for row in got["kernels"].values())
    assert analysis.finite(got["outputs"])
