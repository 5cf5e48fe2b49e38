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
``chip_smoke.py`` holds it (see ``_ssd_close``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (
    FLASH_LIBRARY, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, fused_swiglu,
    gqa_flash_attention, select_flash_variant, select_ssd_variant, select_swiglu_variant,
    ssd_mixer, ssd_scan, swiglu_matmul,
)
from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_ref, swiglu_ref


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
    assert select_flash_variant(D, torch.bfloat16) == "mma"
    q, k, v = _inputs(card, 8, [(2, Sq, D), (2, Sk, D), (2, Sk, D)], torch.bfloat16)
    before = FLASH_LIBRARY.counts["mma"]
    out = flash_attention(q, k, v, causal=causal)
    assert FLASH_LIBRARY.counts["mma"] == before + 1
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), atol=3e-2, rtol=1e-2)


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
