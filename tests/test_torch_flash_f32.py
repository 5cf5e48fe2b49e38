"""The flash ``cuda_core`` kernel's plan and arithmetic, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_card.py``,
``chip_smoke.py``); what decides its launch is Python here and C there,
held equal by ``test_flash_cuda_core_plan_matches_the_card`` on the card:

- ``cuda_core_plan``: the tile class (the smallest of 32/32, 64/64,
  128/128, 192/128 whose q/k head dim holds max(D, Dv)) and the load path
  (``fast``: f32, D and Dv multiples of 4, k, v and o on 16-byte
  boundaries; ``general``: the rest);
- ``cuda_core_grid`` / ``cuda_core_waves``: one CTA a q tile, the last
  (longest causal) q tile first, and the waves that makes;
- ``ref.flash_attention_blocked_ref``: the kernel's arithmetic, the online
  softmax in base 2 over the class's key tiles, each block of 32 rows
  walked twice (even and odd tiles) and merged, with the kernel's masks,
  against ``flash_attention_ref``, the port's CPU route and the JAX
  package's Pallas ``flash_attention`` in interpret mode where that takes
  the shape (Dv = D, S divisible by its blocks), in f32.  The tolerance is
  the flash f32 one of ``tests/test_kernels.py`` (2e-5 + 1e-2·|ref|): the
  sums differ only in their order and base.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jax_flash_attention
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import (
    CUDA_CORE_CLASSES, cuda_core_grid, cuda_core_plan, cuda_core_waves, select_bwd_variant,
    select_variant,
)
from repro_torch.kernels.ref import flash_attention_blocked_ref, flash_attention_ref

F32, BF16 = torch.float32, torch.bfloat16
ATOL, RTOL = 2e-5, 1e-2


@pytest.mark.parametrize("D,Dv,cls", [
    (32, 32, "d32"), (33, 33, "d64"), (16, 32, "d32"), (32, 33, "d64"), (33, 16, "d64"),
    (64, 64, "d64"), (65, 65, "d128"), (64, 65, "d128"), (65, 64, "d128"), (40, 24, "d64"),
    (128, 128, "d128"), (129, 128, "d192"), (128, 16, "d128"), (129, 16, "d192"),
    (192, 128, "d192"), (176, 48, "d192"), (1, 1, "d32"), (192, 1, "d192"),
])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_tile_class_at_the_boundaries(D, Dv, cls, dtype):
    """The class is the smallest whose q/k head dim holds the wider of D
    and Dv, in either dtype; its v head dim holds Dv."""
    got, _ = cuda_core_plan(D, Dv, dtype)
    assert got == cls
    c = CUDA_CORE_CLASSES[got]
    assert max(D, Dv) <= c["dp"] and Dv <= c["dvp"]
    smaller = [n for n, k in CUDA_CORE_CLASSES.items() if k["dp"] < c["dp"]]
    assert all(max(D, Dv) > CUDA_CORE_CLASSES[n]["dp"] for n in smaller)


def test_classes_fit_the_card():
    """Each class's threads are whole warps, two per block of 32 rows; its
    shared memory (Q transposed, the ring of K or V halves of two tiles, a
    P tile a warp) is what the source allocates, and an SM's 228 KB (1 KB
    of it reserved a CTA) fit one CTA and no more."""
    for name, c in CUDA_CORE_CLASSES.items():
        assert c["threads"] == 2 * c["rows"], name
        qld, kld = c["rows"] + 4, c["dp"] + 4
        half = max(c["bk"] * kld, c["bk"] * c["dvp"])
        floats = c["dp"] * qld + c["stages"] * 2 * half + c["threads"] // 32 * c["bk"] * 36
        assert c["smem"] == 4 * floats, name
        assert c["smem"] <= 232448 and 2 * (c["smem"] + 1024) > 233472, name


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@pytest.mark.parametrize("case,D,Dv,dtype,offset,path", [
    ("f32 aligned", 64, 64, F32, 0, "fast"),
    ("f32 192/128", 192, 128, F32, 0, "fast"),
    ("f32 D % 4 != 0", 65, 64, F32, 0, "general"),
    ("f32 Dv % 4 != 0", 64, 66, F32, 0, "general"),
    ("f32 misaligned k", 64, 64, F32, 1, "general"),
    ("bf16 aligned", 64, 64, BF16, 0, "general"),
    ("bf16 D % 16 != 0", 40, 24, BF16, 0, "general"),
])
def test_load_path(case, D, Dv, dtype, offset, path):
    """The 16-byte K and V copies and the output's 16-byte stores need f32,
    D and Dv multiples of 4 and k, v and o on 16-byte boundaries (o the
    wrapper allocates; q goes 4 bytes at a time); a view one element into
    its storage is not."""
    buf = torch.zeros(offset + 8 * D, dtype=dtype)
    k = buf[offset:].view(8, D)
    v, o = torch.zeros(8, Dv, dtype=dtype), torch.zeros(8, Dv, dtype=dtype)
    assert cuda_core_plan(D, Dv, dtype, aligned=_aligned(k, v, o))[1] == path, case


def test_plan_refuses_what_the_entry_refuses():
    for args in [(0, 64, F32), (64, 0, F32), (193, 64, F32), (64, 129, F32),
                 (64, 64, torch.float16)]:
        with pytest.raises(ValueError):
            cuda_core_plan(*args)


def test_selectors_send_these_calls_to_cuda_core():
    """f32 at any head dims, and bf16 whose D or Dv is not a multiple of
    16, go to ``cuda_core``; its backward is the PyTorch VJP."""
    for D, Dv, dtype in [(64, 64, F32), (128, 128, F32), (192, 128, F32), (40, 24, BF16),
                         (64, 24, BF16), (100, 64, BF16)]:
        assert select_variant(D, Dv, dtype) == "cuda_core"
        assert select_bwd_variant(D, Dv, dtype) == "vjp"
    assert select_variant(64, 64, BF16) == "mma"


@pytest.mark.parametrize("BH,Sq,cls", [(3, 1024, "d64"), (2, 300, "d128"), (1, 1, "d32"),
                                       (4, 129, "d192"), (2, 65, "d64")])
def test_grid_takes_every_q_tile_once_longest_first(BH, Sq, cls):
    """The launch order covers every (head, q tile) once, heads fastest,
    the q tiles from the last (the longest under a causal mask) down."""
    grid = cuda_core_grid(BH, Sq, cls)
    n = -(-Sq // CUDA_CORE_CLASSES[cls]["rows"])
    assert sorted(grid) == [(bh, t) for bh in range(BH) for t in range(n)]
    tiles = [t for _, t in grid]
    assert tiles == sorted(tiles, reverse=True)
    assert [bh for bh, _ in grid[:BH]] == list(range(BH))


@pytest.mark.parametrize("BH,Sq,cls,sms,ctas,waves", [
    (32, 1024, "d64", 132, 256, 2),   # the reported D 64 shape: 1.94 waves
    (32, 1024, "d128", 132, 256, 2),
    (16, 1024, "d192", 132, 256, 2),  # MLA: q tiles of 64 rows
    (32, 128, "d64", 132, 32, 1),
    (132, 128, "d64", 132, 132, 1),
    (133, 128, "d64", 132, 133, 2),
    (16, 130, "d192", 132, 48, 1),
    (2, 100, "d32", 66, 2, 1),
])
def test_waves(BH, Sq, cls, sms, ctas, waves):
    assert cuda_core_waves(BH, Sq, cls, sms) == (ctas, waves)


def _np_inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (Sq, Sk, D, Dv, causal): ragged ends, Sq != Sk both ways (Sq > Sk causal:
# rows that see no key), every class, non-causal, key tiles of both sizes
CASES = [(100, 130, 64, 64, True), (130, 100, 64, 64, True), (130, 100, 64, 64, False),
         (300, 300, 64, 64, True), (96, 96, 40, 24, True), (77, 77, 40, 24, False),
         (200, 200, 128, 128, True), (70, 130, 128, 128, False), (150, 150, 176, 48, True),
         (100, 100, 192, 128, True), (64, 64, 32, 32, True), (5, 3, 16, 16, True),
         (1, 200, 33, 33, True), (260, 10, 64, 64, True)]


@pytest.mark.parametrize("Sq,Sk,D,Dv,causal", CASES)
def test_blocked_softmax_matches_the_references(Sq, Sk, D, Dv, causal):
    """The kernel's arithmetic on the CPU (its class's key tiles, two
    walks merged, base 2, its masks) against ``flash_attention_ref`` and
    the port's CPU route, in f32, within 2e-5 + 1e-2·|ref|."""
    q, k, v = (torch.from_numpy(a) for a in _np_inputs(
        Sq * 7 + Sk, [(2, Sq, D), (2, Sk, D), (2, Sk, Dv)]))
    bk = CUDA_CORE_CLASSES[cuda_core_plan(D, Dv, F32)[0]]["bk"]
    got = flash_attention_blocked_ref(q, k, v, causal, bk=bk)
    assert got.dtype == F32 and got.shape == (2, Sq, Dv)
    for want in (flash_attention_ref(q, k, v, causal=causal),
                 flash_attention(q, k, v, causal=causal)):
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("Sq,Sk,D,causal", [(128, 128, 64, True), (100, 130, 64, True),
                                            (130, 100, 64, True), (64, 64, 128, False),
                                            (96, 96, 32, True), (40, 40, 40, False)])
def test_blocked_softmax_matches_the_pallas_kernel(Sq, Sk, D, causal):
    """Against the JAX package's Pallas ``flash_attention`` in interpret
    mode (Dv = D; one block a sequence, so any length divides), f32."""
    q, k, v = _np_inputs(Sq + 3 * Sk + D, [(2, Sq, D), (2, Sk, D), (2, Sk, D)])
    got = flash_attention_blocked_ref(*(torch.from_numpy(a) for a in (q, k, v)), causal,
                                      bk=CUDA_CORE_CLASSES[cuda_core_plan(D, D, F32)[0]]["bk"])
    want = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL, rtol=RTOL)


def test_a_row_that_sees_no_key_is_uniform():
    """Causal with Sq > Sk: rows i < Sq - Sk see no key and get the mean of
    v over the real keys, as the reference's finite mask gives them."""
    Sq, Sk, D = 200, 70, 64
    q, k, v = (torch.from_numpy(a) for a in _np_inputs(11, [(1, Sq, D), (1, Sk, D), (1, Sk, D)]))
    got = flash_attention_blocked_ref(q, k, v, True, bk=64)
    blind = Sq - Sk
    torch.testing.assert_close(got[0, :blind], v[0].mean(0).expand(blind, D), atol=ATOL,
                               rtol=RTOL)
    torch.testing.assert_close(got, flash_attention_ref(q, k, v, causal=True), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("Sq,Sk,D,causal", [(300, 300, 64, True), (200, 200, 128, False)])
def test_alpha_not_applied_breaks_the_tolerance(Sq, Sk, D, causal):
    """A planted fault, the accumulators left unscaled as a walk's max
    grows, is far outside the tolerance once a walk has two tiles."""
    q, k, v = (torch.from_numpy(a) for a in _np_inputs(5, [(2, Sq, D), (2, Sk, D), (2, Sk, D)]))
    bk = CUDA_CORE_CLASSES[cuda_core_plan(D, D, F32)[0]]["bk"]
    want = flash_attention_ref(q, k, v, causal=causal)
    faulty = flash_attention_blocked_ref(q, k, v, causal, bk=bk, alpha=False)
    assert not torch.allclose(faulty, want, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(flash_attention_blocked_ref(q, k, v, causal, bk=bk), want,
                               atol=ATOL, rtol=RTOL)
