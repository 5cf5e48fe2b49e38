"""The SwiGLU ``cuda_core`` kernel's plan and arithmetic, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_card.py``,
``chip_smoke.py``); what decides its launch is Python here and C there,
held equal by ``test_cuda_core_plan_matches_the_card`` on the card:

- ``cuda_core_plan``: the tile class (``small`` for M <= 16, else ``r64``
  or ``r128`` by a wave-count model) and the load path (``fast``: f32, F a
  multiple of 4, wg, wu and out on 16-byte boundaries; ``general``: the
  rest);
- ``ref.swiglu_ksplit_ref``: the small class's sum, four k groups of
  every 32-row stage added in group order, against ``swiglu_ref`` and the
  JAX package's Pallas ``swiglu_matmul`` in interpret mode, in f32.  The
  tolerance is the SwiGLU f32 one of ``tests/test_kernels.py`` (1e-4 +
  2e-2·|ref|): the sums differ only in their order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import swiglu_matmul as jax_swiglu_matmul
from repro_torch.kernels import swiglu_experts, swiglu_matmul
from repro_torch.kernels.ref import swiglu_experts_ref, swiglu_ksplit_ref, swiglu_ref
from repro_torch.kernels.swiglu_matmul import (
    CUDA_CORE_CLASSES, CUDA_CORE_SMALL_M, cuda_core_plan, select_experts_variant,
    select_variant,
)

SMS = 132  # an H100 SXM's SMs
F32, BF16 = torch.float32, torch.bfloat16


def _waves(E, M, F, cls, sms=SMS):
    """(tiles, waves, cost) of a call on tile class ``cls``, as the model
    counts them."""
    c = CUDA_CORE_CLASSES[cls]
    tiles = E * -(-M // c["bm"]) * -(-F // c["bn"])
    waves = -(-tiles // (sms * c["ctas"]))
    return tiles, waves, waves * c["ctas"] * c["bm"] * c["bn"]


# (E, M, D, F, class, tiles, waves): the two reported path shapes, M 8 and 1
# (the small class), the small class's boundary (16 / 17), the 64- and
# 128-row tiles' rows ± 1, the experts at 64 and 65 rows, and M 576, where
# the 64-row class takes one wave and the 128-row class two
PLANS = [
    (1, 512, 2048, 5632, "r128", 352, 1),   # 89% of one wave's 396 slots
    (64, 120, 2048, 1408, "r128", 1408, 4),
    (1, 8, 2048, 5632, "small", 176, None),
    (1, 1, 2048, 5632, "small", 176, None),
    (1, 16, 2048, 5632, "small", 176, None),
    (1, 17, 2048, 5632, "r128", 88, 1),
    (1, 63, 2048, 5632, "r128", 88, 1),
    (1, 64, 2048, 5632, "r128", 88, 1),
    (1, 65, 2048, 5632, "r128", 88, 1),
    (1, 127, 2048, 5632, "r128", 88, 1),
    (1, 128, 2048, 5632, "r128", 88, 1),
    (1, 129, 2048, 5632, "r128", 176, 1),
    (1, 576, 2048, 5632, "r64", 792, 1),
    (64, 64, 2048, 1408, "r64", 1408, 2),
    (64, 65, 2048, 1408, "r128", 1408, 4),
    (64, 8, 2048, 1408, "small", 2816, None),
]


@pytest.mark.parametrize("E,M,D,F,cls,tiles,waves", PLANS)
def test_tile_class(E, M, D, F, cls, tiles, waves):
    """The class the model picks, its tiles and waves; the class minimises
    the model's cost among the two for M > 16, and the small class runs
    exactly the calls of M <= 16.  Every class takes any M, D and F (its
    grid covers ceil(M / rows) x ceil(F / columns) tiles a product)."""
    got, _ = cuda_core_plan(E, M, D, F, F32)
    assert got == cls
    assert (got == "small") == (M <= CUDA_CORE_SMALL_M)
    if got == "small":
        c = CUDA_CORE_CLASSES["small"]
        assert E * -(-M // c["bm"]) * -(-F // c["bn"]) == tiles
        return
    assert _waves(E, M, F, got)[:2] == (tiles, waves)
    other = "r64" if got == "r128" else "r128"
    assert _waves(E, M, F, got)[2] <= _waves(E, M, F, other)[2]
    if _waves(E, M, F, got)[2] == _waves(E, M, F, other)[2]:
        assert got == "r128"  # the larger tile on a tie


@pytest.mark.parametrize("sms", [66, 114, 132])
@pytest.mark.parametrize("M", [17, 100, 200, 512, 576, 1000, 4096])
def test_tile_class_minimises_the_waves_model(sms, M):
    """On cards of other SM counts too, the class picked costs no more than
    the other: ceil(tiles / (SMs x CTAs)) x CTAs x rows x columns."""
    got, _ = cuda_core_plan(1, M, 2048, 5632, F32, sms=sms)
    other = "r64" if got == "r128" else "r128"
    assert _waves(1, M, 5632, got, sms)[2] <= _waves(1, M, 5632, other, sms)[2]


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


@pytest.mark.parametrize("case,D,F,dtype,offset,path", [
    ("f32 aligned", 2048, 5632, F32, 0, "fast"),
    # x goes 4 bytes at a time, transposed on its way into shared memory, so
    # D needs nothing: a K tail is zero-filled by the copies' source size
    ("f32 D % 4 != 0", 2050, 5632, F32, 0, "fast"),
    ("f32 F % 4 != 0", 2048, 5630, F32, 0, "general"),
    ("bf16 D % 8 != 0", 100, 64, BF16, 0, "general"),
    ("bf16 F % 8 != 0", 64, 70, BF16, 0, "general"),
    ("bf16 aligned", 64, 64, BF16, 0, "general"),   # bf16 takes the tensor cores there
    ("f32 misaligned view", 64, 64, F32, 1, "general"),
])
def test_load_path(case, D, F, dtype, offset, path):
    """The load path of each kind of operand: the 16-byte weight copies and
    stores need f32, F % 4 == 0 and 16-byte aligned wg, wu (and out, which
    the wrapper allocates); a view one element into its storage is not."""
    buf = torch.zeros(offset + D * F, dtype=dtype)
    wg = buf[offset:].view(D, F)
    wu = torch.zeros(D, F, dtype=dtype)
    assert cuda_core_plan(1, 8, D, F, dtype, aligned=_aligned(wg, wu))[1] == path, case


def test_selectors_send_these_calls_to_cuda_core():
    """Every call the plan is for goes to ``cuda_core``: f32 at any shape,
    bf16 with D or F not a multiple of 8."""
    for M, D, F, dtype in [(512, 2048, 5632, F32), (8, 2050, 5632, F32), (8, 100, 64, BF16),
                           (200, 64, 70, BF16)]:
        assert select_variant(M, D, F, dtype) == "cuda_core"
        assert select_experts_variant(M, D, F, dtype) == "experts_cuda_core"
    assert select_variant(8, 64, 64, BF16) == "decode"


def test_plan_refuses_what_the_entries_refuse():
    for args in [(0, 8, 64, 64, F32), (1, 0, 64, 64, F32), (1, 8, 64, 64, torch.float16)]:
        with pytest.raises(ValueError):
            cuda_core_plan(*args)


def _np_inputs(seed, shapes, scales):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * sc).astype(np.float32) for s, sc in zip(shapes, scales)]


@pytest.mark.parametrize("M,D,F", [(8, 256, 96), (16, 128, 64), (5, 100, 70), (1, 96, 32)])
def test_ksplit_sum_matches_the_references(M, D, F):
    """The small class's split sum (4 k groups of every 32-row stage, added
    in group order) against ``swiglu_ref``, the port's CPU route
    (``swiglu_matmul``) and the JAX package's Pallas kernel in interpret
    mode, in f32, within 1e-4 + 2e-2·|ref|; a ragged K (100) puts part of a
    stage past D."""
    x, wg, wu = _np_inputs(3, [(M, D), (D, F), (D, F)], [1.0, D ** -0.5, D ** -0.5])
    tx, tg, tu = (torch.from_numpy(a) for a in (x, wg, wu))
    c = CUDA_CORE_CLASSES["small"]
    got = swiglu_ksplit_ref(tx, tg, tu, c["bk"], c["ksplit"])
    assert got.dtype == F32 and got.shape == (M, F)
    for want in (swiglu_ref(tx, tg, tu), swiglu_matmul(tx, tg, tu)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=2e-2)
    jax_out = jax_swiglu_matmul(jnp.asarray(x), jnp.asarray(wg), jnp.asarray(wu), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_out, np.float32), atol=1e-4,
                               rtol=2e-2)


def test_ksplit_sum_of_experts():
    """The same for the expert entry (a leading expert dim)."""
    E, M, D, F = 3, 7, 100, 70
    x, wg, wu = (torch.from_numpy(a) for a in _np_inputs(
        4, [(E, M, D), (E, D, F), (E, D, F)], [1.0, D ** -0.5, D ** -0.5]))
    got = swiglu_ksplit_ref(x, wg, wu, 32, 4)
    torch.testing.assert_close(got, swiglu_experts_ref(x, wg, wu), atol=1e-4, rtol=2e-2)
    torch.testing.assert_close(got, swiglu_experts(x, wg, wu), atol=1e-4, rtol=2e-2)


def test_ksplit_groups_cover_every_k_once():
    """Each k row belongs to exactly one group: a group dropped (the
    partials of 3 of 4) leaves the model far outside the tolerance."""
    M, D, F = 8, 256, 96
    x, wg, wu = (torch.from_numpy(a) for a in _np_inputs(5, [(M, D), (D, F), (D, F)],
                                                         [1.0, D ** -0.5, D ** -0.5]))
    group = torch.arange(D) % 32 // 8
    assert torch.equal(torch.bincount(group), torch.full((4,), D // 4))
    keep = group != 3
    dropped = swiglu_ref(x[:, keep], wg[keep], wu[keep])
    want = swiglu_ref(x, wg, wu)
    assert not torch.allclose(dropped, want, atol=1e-4, rtol=2e-2)
    torch.testing.assert_close(swiglu_ksplit_ref(x, wg, wu, 32, 4), want, atol=1e-4, rtol=2e-2)
