"""The SSD scan's f32 CUDA-core variant (``ssd_scan[cuda_core]``) off the card.

The kernel itself (``csrc/ssd_scan.cu``, namespace ``simt``) runs only on
the card; ``tests/test_torch_card.py`` holds it there.  Here: what decides
and models it.

- The Python mirror of the C side's choices (``kernels/ssd_scan.py``): the
  tile class at each boundary of the state width N, the columns of P a CTA
  takes (ragged tiles), the load path by dtype, head dim and alignment, the
  scratch a call takes, and the model of the phases' CTAs and waves.
- A PyTorch model of the kernel's arithmetic (``ref.ssd_scan_three_phase``
  at the variant's chunk, ``split=False``: its three phases over chunks of
  64, every product in f32), held against the exact recurrence
  (``ref.ssd_scan_ref``) at the card's tolerance, and against the JAX
  package's Pallas kernel in interpret mode and its model's
  ``_ssd_chunked`` at ``tests/test_torch_kernels.py``'s tolerance, over
  ragged lengths, one position, one chunk, head dims 16/24/64, state widths
  8/16/128 and slow decay (dt ~0.02, where the carried state counts).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssd_scan as jax_ssd_scan
from repro.models import ssm as jax_ssm
from repro_torch.kernels.ref import ssd_scan_ref, ssd_scan_three_phase

ssd = importlib.import_module("repro_torch.kernels.ssd_scan")
F32, BF16 = torch.float32, torch.bfloat16


# --------------------------------------------------------------------------- #
# the plan mirror
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("N,cls", [(4, "n32"), (16, "n32"), (20, "n32"), (32, "n32"),
                                   (36, "n128"), (64, "n128"), (68, "n128"), (128, "n128")])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_tile_class_at_state_width_boundaries(N, cls, dtype):
    """The smallest class whose tiles hold N, whatever the dtype: Jamba's 16
    and every N up to 32 on the small class, the rest on the 128 class's
    tiles (zero past N)."""
    assert ssd.cuda_core_plan(64, N, dtype)[0] == cls
    assert N <= ssd.CUDA_CORE_CLASSES[cls]["np"]


@pytest.mark.parametrize("P,N,dtype", [(64, 0, F32), (64, 6, F32), (64, 130, F32),
                                       (64, 132, F32), (64, 256, BF16), (0, 16, F32),
                                       (64, 16, torch.float64)])
def test_refused_shapes_have_no_plan(P, N, dtype):
    """N must be a multiple of 4 up to 128 (the entry refuses the rest, as
    ``test_ssd_shapes_no_variant_takes_raise`` shows on the card)."""
    with pytest.raises(ValueError, match="no CUDA-core plan"):
        ssd.cuda_core_plan(P, N, dtype)


@pytest.mark.parametrize("dtype,P,aligned,path", [
    (F32, 64, True, "fast"), (F32, 24, True, "fast"), (F32, 4, True, "fast"),
    (F32, 64, False, "general"), (F32, 30, True, "general"), (F32, 1, True, "general"),
    (BF16, 64, True, "general"), (BF16, 24, False, "general"),
])
def test_load_path_by_dtype_width_and_alignment(dtype, P, aligned, path):
    """16-byte copies need f32, rows of x and y in whole float4s (P % 4 ==
    0) and operands on 16-byte boundaries; everything else takes element
    loads converted to f32."""
    for N in (16, 48, 128):
        assert ssd.cuda_core_plan(P, N, dtype, aligned)[1] == path


def test_classes_fit_their_launch_bounds_and_shared_memory():
    """Each class's tiles: 64 positions, 64 columns of P, eight warps in
    phase 3; phase 1 and phase 3's shared memory as the C side lays it out
    (x, B and the scans; C and B in rows of N + 4 floats, S^T in rows of
    68, h^T in B's place), within the SM's 227 KB at the CTAs an SM the
    card gives."""
    Q, PT = 64, 64
    for name, c in ssd.CUDA_CORE_CLASSES.items():
        NP, LD, SL = c["np"], c["np"] + 4, Q + 4
        assert (c["chunk"], c["p_tile"], c["scan_threads"]) == (Q, PT, 256)
        assert c["chunk"] == ssd.CHUNK["cuda_core"]
        assert c["state_smem"] == 4 * (Q * PT + Q * NP + 2 * Q)
        assert c["scan_smem"] == 4 * (Q * LD + max(Q * LD, Q * SL, NP * PT) + Q * PT + 2 * Q)
        for phase in ("state", "scan"):
            assert c[f"{phase}_ctas"] * (c[f"{phase}_smem"] + 1024) <= 233472, name
    assert [c["np"] for c in ssd.CUDA_CORE_CLASSES.values()] == [32, 128]


@pytest.mark.parametrize("code,plan", [(0, ("n32", "general")), (1, ("n32", "fast")),
                                       (2, ("n128", "general")), (3, ("n128", "fast"))])
def test_plan_code_decodes(code, plan):
    """The C side's plan code (class index times 2, plus 1 on the fast path)
    read back into (class, path), and each plan's code from the mirror."""
    assert ssd.cuda_core_plan_of_code(code) == plan
    names = list(ssd.CUDA_CORE_CLASSES)
    assert 2 * names.index(plan[0]) + (plan[1] == "fast") == code


@pytest.mark.parametrize("code", [-1, 4, 7])
def test_plan_code_out_of_range_raises(code):
    """No class answers a code past the classes (the C side's -1 included)."""
    with pytest.raises(ValueError, match="no CUDA-core plan"):
        ssd.cuda_core_plan_of_code(code)


@pytest.mark.parametrize("BH,S,P,N", [(32, 1024, 64, 128), (128, 1024, 64, 16), (2, 100, 30, 8),
                                      (3, 1, 24, 16), (1, 64, 130, 36), (2, 65, 1, 4)])
def test_scratch_floats(BH, S, P, N):
    """Each chunk's state [N, P padded to a multiple of 4] (phase 1's term,
    then the state the chunk starts from), then each chunk's decay: 16.8 MB
    at mamba2's heads (BH 32, S 1024, P 64, N 128), 8.4 MB at Jamba's."""
    nch, PP = -(-S // 64), -(-P // 4) * 4
    assert ssd.cuda_core_scratch_floats(BH, S, P, N) == BH * nch * (N * PP + 1)
    assert (BH * nch * N * PP) % 4 == 0  # the decays start on 16 bytes
    if (BH, S, P, N) == (32, 1024, 64, 128):
        assert BH * nch * N * PP * 4 == 16_777_216
    if (BH, S, P, N) == (128, 1024, 64, 16):
        assert BH * nch * N * PP * 4 == 8_388_608


@pytest.mark.parametrize("BH,S,P,N,ctas,state_waves,scan_waves", [
    (32, 1024, 64, 128, 512, 1, 2),     # mamba2's heads: 4 and 2 CTAs an SM
    (128, 1024, 64, 16, 2048, 3, 6),    # Jamba's: the N32 class, 7 and 3 an SM
    (32, 1024, 64, 48, 512, 1, 2),      # N 48 on the N128 class's tiles
    (2, 100, 130, 16, 12, 1, 1),        # ragged S and P: 2 chunks x 3 P tiles
    (1, 1, 16, 8, 1, 1, 1),             # one position
])
def test_waves_model(BH, S, P, N, ctas, state_waves, scan_waves):
    """One CTA a (sequence, chunk of 64, 64 columns of P) in both product
    phases; waves over 132 SMs at the class's CTAs an SM."""
    w = ssd.cuda_core_waves(BH, S, P, N)
    assert w == {"state": (ctas, state_waves), "scan": (ctas, scan_waves)}


@pytest.mark.parametrize("P", [16, 24, 64, 65, 128, 130])
def test_ragged_p_tiles(P):
    """The grid's z axis walks P in tiles of 64: the last one ragged."""
    assert ssd.cuda_core_waves(2, 64, P, 16)["state"][0] == 2 * -(-P // 64)


# --------------------------------------------------------------------------- #
# the kernel's arithmetic
# --------------------------------------------------------------------------- #
def _inputs(seed, BH, S, P, N, dt_shift=0.0):
    """x, dt, A, B, C for both packages (f32), drawn as
    ``tests/test_torch_kernels.py`` draws them; dt_shift 4 makes dt ~0.02,
    where a chunk of 64 decays by 0.1-0.4 and the carried state counts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((BH, S)) - dt_shift).astype(np.float32)
    A = -np.exp(rng.standard_normal(BH) * 0.5).astype(np.float32)
    B = (rng.standard_normal((BH, S, N)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((BH, S, N)) * 0.5).astype(np.float32)
    return (x, dt, A, B, C), tuple(torch.from_numpy(t) for t in (x, dt, A, B, C))


def _model(x, dt, A, B, C, return_state=False):
    """The CUDA-core kernel's phases on ``[BH, S, *]`` operands (each
    sequence a batch row of one head and one group, as ``ssd_scan`` hands
    them to it): chunks of ``CHUNK["cuda_core"]``, every product in f32."""
    out = ssd_scan_three_phase(x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None],
                               C[:, :, None], return_state=return_state,
                               chunk=ssd.CHUNK["cuda_core"], split=False)
    return (out[0][:, :, 0], out[1][:, 0]) if return_state else out[:, :, 0]


def _ssd_tol(ref):
    """``tests/test_torch_kernels.py``'s f32 tolerance for the SSD scan."""
    return 2e-3 * max(float(np.abs(np.asarray(ref, dtype=np.float32)).max()), 1.0)


def _card_ratio(out, ref):
    """Largest error over the card's f32 tolerance (``chip_smoke.py``'s
    SSD_Y_TOL and SSD_STATE_TOL: 1e-4·max(|ref|, 1)), element by element."""
    out, ref = out.float(), ref.float()
    return float(((out - ref).abs() / (1e-4 * max(float(ref.abs().max()), 1.0))).max())


# (BH, S, P, N, dt_shift): ragged lengths, one position, one chunk, head dims
# 16/24/64, state widths 8/16/128, slow decay
MODEL_CASES = [(2, 100, 64, 128, 0.0), (1, 1, 64, 128, 0.0), (2, 64, 64, 64, 0.0),
               (2, 130, 16, 8, 0.0), (1, 37, 24, 16, 0.0), (2, 300, 64, 128, 4.0),
               (2, 300, 24, 16, 4.0), (1, 200, 16, 8, 4.0), (3, 129, 64, 16, 4.0)]


@pytest.mark.parametrize("BH,S,P,N,dt_shift", MODEL_CASES)
def test_model_matches_exact_recurrence(BH, S, P, N, dt_shift):
    """y and the final state within the tolerance the card holds the kernel
    to, against the sequential recurrence."""
    _, tin = _inputs(21, BH, S, P, N, dt_shift)
    y, h = _model(*tin, return_state=True)
    ry, rh = ssd_scan_ref(*tin, return_state=True)
    assert y.shape == (BH, S, P) and h.shape == (BH, P, N) and h.dtype == F32
    assert _card_ratio(y, ry) <= 1.0
    assert _card_ratio(h, rh) <= 1.0


@pytest.mark.parametrize("BH,S,P,N,bs", [(2, 128, 32, 64, 32), (3, 256, 64, 128, 64),
                                         (2, 128, 64, 32, 128), (1, 64, 16, 16, 16),
                                         (2, 192, 24, 8, 64), (1, 256, 64, 16, 256)])
@pytest.mark.parametrize("dt_shift", [0.0, 4.0])
def test_model_matches_pallas_kernel(BH, S, P, N, bs, dt_shift):
    """y against the JAX package's Pallas kernel in interpret mode (its
    block divides S)."""
    jin, tin = _inputs(22, BH, S, P, N, dt_shift)
    ref = jax_ssd_scan(*map(jnp.asarray, jin), block_s=bs, interpret=True)
    out = _model(*tin)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=_ssd_tol(ref))


@pytest.mark.parametrize("BH,S,P,N,dt_shift", MODEL_CASES)
def test_model_matches_model_chunked_ssd(BH, S, P, N, dt_shift):
    """y and the final state against the JAX model's ``_ssd_chunked`` (its
    own chunk of 16, any length), the sequences as heads of one batch row."""
    (x, dt, A, B, C), tin = _inputs(23, BH, S, P, N, dt_shift)
    ref_y, ref_h = jax_ssm._ssd_chunked(
        jnp.moveaxis(jnp.asarray(x), 0, 1)[None], jnp.moveaxis(jnp.asarray(dt), 0, 1)[None],
        jnp.asarray(A), jnp.moveaxis(jnp.asarray(B), 0, 1)[None],
        jnp.moveaxis(jnp.asarray(C), 0, 1)[None], chunk=16)
    y, h = _model(*tin, return_state=True)
    np.testing.assert_allclose(y.numpy(), np.moveaxis(np.asarray(ref_y[0]), 1, 0), rtol=0,
                               atol=_ssd_tol(ref_y))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h[0]), rtol=0, atol=_ssd_tol(ref_h))


@pytest.mark.parametrize("chunk", [16, 32, 128])
def test_chunk_length_moves_only_rounding(chunk):
    """The chunked form at another chunk length sums the same terms in
    another order: the earlier kernel's 32 and the model's 64 agree to f32
    rounding, where the carried state counts."""
    _, tin = _inputs(24, 2, 300, 64, 16, 4.0)
    y, h = _model(*tin, return_state=True)
    y2, h2 = ssd_scan_three_phase(*(t[:, :, None] if t.ndim > 1 else t[:, None] for t in tin),
                                  return_state=True, chunk=chunk, split=False)
    torch.testing.assert_close(y2[:, :, 0], y, rtol=0, atol=1e-5 * float(y.abs().max()))
    torch.testing.assert_close(h2[:, 0], h, rtol=0, atol=1e-5 * float(h.abs().max()))


def test_model_without_the_carry_fails():
    """Planted fault: each chunk starting from a zero state (chunks as long
    as the sequence then differ from chunks of 64).  At slow decay the
    carried state counts, and y misses the card's tolerance many times over."""
    _, tin = _inputs(25, 2, 300, 64, 16, 4.0)
    ry = ssd_scan_ref(*tin)
    y = torch.cat([_model(*(t[:, s:s + 64] if t.ndim > 1 else t for t in tin))
                   for s in range(0, 300, 64)], dim=1)
    assert _card_ratio(y, ry) > 10.0
