"""Which hand-written kernel a CUDA call of the port launches.

``swiglu_matmul`` (with its expert-batched entries), ``flash_attention``
and ``ssd_scan`` each hold several CUDA kernels; their wrappers pick one by a
pure function of the shapes and the dtype (``select_variant``,
``select_experts_variant``), which these tests hold on the CPU: the
serving path's bf16 shapes go to the tensor-core kernels, f32 and bf16
shapes the tensor cores cannot take go to the CUDA-core kernels.  They also check that every
variant's entry point exists in its CUDA source, and that a CPU tensor
launches nothing whatever its shape.  The kernels themselves run only on the
card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (
    CONV_LIBRARY, FLASH_LIBRARY, LIBRARIES, SSD_LIBRARY, SWIGLU_LIBRARY, causal_conv,
    flash_attention, fused_swiglu, gqa_bidirectional_attention, gqa_flash_attention,
    select_experts_variant, select_flash_variant, select_ssd_variant, select_swiglu_variant,
    ssd_mixer, ssd_scan, swiglu_experts, swiglu_matmul,
)
from repro_torch.kernels.swiglu_matmul import PREFILL_MIN_M

BF16, F32 = torch.bfloat16, torch.float32
# TinyLlama-1.1B's MLP and attention widths, as the serving path calls them
D_MODEL, D_FF, HEAD_DIM = 2048, 5632, 64


@pytest.mark.parametrize("M,variant", [(8, "decode"), (79, "wgmma"), (512, "wgmma"),
                                       (1024, "wgmma")])
def test_swiglu_serving_shapes_take_tensor_cores(M, variant):
    """Decode (8 slots) streams the weights through the mma.sync kernel;
    prefill rows (79 to 1024 after padding) go to wgmma."""
    assert select_swiglu_variant(M, D_MODEL, D_FF, BF16) == variant


@pytest.mark.parametrize("M", [1, 16, PREFILL_MIN_M - 1, PREFILL_MIN_M, PREFILL_MIN_M + 1, 4096])
def test_swiglu_threshold(M):
    expect = "wgmma" if M >= PREFILL_MIN_M else "decode"
    assert select_swiglu_variant(M, 256, 96, BF16) == expect


@pytest.mark.parametrize("M,D,F,dtype", [
    (8, D_MODEL, D_FF, F32),      # f32 decode
    (512, D_MODEL, D_FF, F32),    # f32 prefill
    (5, 100, 70, BF16),           # the sweep's unaligned case: D and F not multiples of 8
    (64, 2052, 5632, BF16),       # D not a multiple of 8 (TMA needs 16-byte row strides)
    (8, 2048, 5636, BF16),        # F not a multiple of 8
    (512, 2048, 5636, BF16),
])
def test_swiglu_other_shapes_take_cuda_cores(M, D, F, dtype):
    assert select_swiglu_variant(M, D, F, dtype) == "cuda_core"


@pytest.mark.parametrize("S", [128, 996, 1024])
def test_flash_serving_shapes_take_tensor_cores(S):
    """Prefill attention of every prompt length: head dim 64, bf16."""
    assert select_flash_variant(HEAD_DIM, HEAD_DIM, BF16) == "mma"


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_head_dims_on_tensor_cores(D):
    assert select_flash_variant(D, D, BF16) == "mma"


@pytest.mark.parametrize("D,dtype", [(64, F32), (128, F32), (8, BF16), (40, BF16), (72, BF16),
                                     (100, BF16), (144, BF16)])
def test_flash_other_head_dims_take_cuda_cores(D, dtype):
    assert select_flash_variant(D, D, dtype) == "cuda_core"


@pytest.mark.parametrize("D,Dv", [(192, 128), (144, 128), (192, 64), (64, 32), (32, 128),
                                  (176, 16)])
def test_flash_value_head_dims_on_tensor_cores(D, Dv):
    """MLA's prefill (D = 192 = 128 nope + 64 rope, Dv = 128) and other
    pairs: D a multiple of 16 up to 192, Dv one up to 128."""
    assert select_flash_variant(D, Dv, BF16) == "mma"


@pytest.mark.parametrize("D,Dv,dtype", [(192, 128, F32), (208, 128, BF16), (192, 144, BF16),
                                        (192, 136, BF16), (200, 128, BF16), (24, 16, BF16)])
def test_flash_other_value_head_dims_take_cuda_cores(D, Dv, dtype):
    """f32 at MLA's dims, and bf16 past the mma tiles (D > 192, Dv > 128)
    or off the multiples of 16 (the reduced MLA config: D 24, Dv 16)."""
    assert select_flash_variant(D, Dv, dtype) == "cuda_core"


@pytest.mark.parametrize("M,variant", [(8, "experts_decode"), (63, "experts_decode"),
                                       (64, "experts_wgmma"), (120, "experts_wgmma")])
def test_experts_serving_shapes_take_tensor_cores(M, variant):
    """DeepSeek-V2-Lite's routed experts (D 2048, F 1408), M rows an
    expert: a decode tick's 8 slots of capacity 1, a prefill's capacity of
    8 to 63 rows (n < 538 tokens) to the decode kernel, 64 to 120 (n >= 538)
    to wgmma."""
    assert select_experts_variant(M, 2048, 1408, BF16) == variant


@pytest.mark.parametrize("n,M", [(64, 8), (537, 63), (538, 64), (1024, 120)])
def test_experts_rows_of_a_prefill(n, M):
    """The capacity of a prefill of n tokens (one group), which sets the
    expert kernel's rows: ceil(6 n / 64 · 1.25)."""
    from repro_torch.models.layers import moe_capacity
    moe = get_config("deepseek-v2-lite-16b").moe
    assert moe_capacity(moe, n) == M
    assert select_experts_variant(M, 2048, 1408, BF16) == (
        "experts_wgmma" if n >= 538 else "experts_decode")


@pytest.mark.parametrize("M,D,F,dtype", [(8, 2048, 1408, F32), (120, 2048, 1408, F32),
                                         (8, 100, 70, BF16), (120, 2048, 1404, BF16)])
def test_experts_other_shapes_take_cuda_cores(M, D, F, dtype):
    assert select_experts_variant(M, D, F, dtype) == "experts_cuda_core"


@pytest.mark.parametrize("M,D,F,dtype", [(8, 2048, 1408, BF16), (120, 2048, 1408, BF16),
                                         (5, 100, 70, F32), (64, 256, 96, BF16)])
def test_experts_selector_follows_the_dense_one(M, D, F, dtype):
    assert select_experts_variant(M, D, F, dtype) == "experts_" + select_swiglu_variant(
        M, D, F, dtype)


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssd_model_shapes_take_tensor_cores(arch):
    """The SSM mixers' own widths in bf16: head dim 64, state 128 (mamba2)
    and 16 (jamba)."""
    s = get_config(arch).ssm
    assert select_ssd_variant(s.head_dim, s.d_state, BF16) == "wgmma"


@pytest.mark.parametrize("N", [16, 32, 48, 64, 80, 96, 112, 128])
def test_ssd_state_widths_on_tensor_cores(N):
    assert select_ssd_variant(64, N, BF16) == "wgmma"


@pytest.mark.parametrize("P,N,dtype", [
    (64, 128, F32), (64, 16, F32),  # f32 at the models' widths
    (32, 64, BF16), (16, 16, BF16), (24, 8, BF16), (128, 128, BF16),  # head dims other than 64
    (64, 8, BF16), (64, 40, BF16), (64, 136, BF16), (64, 256, BF16),  # N no multiple of 16, or > 128
])
def test_ssd_other_shapes_take_cuda_cores(P, N, dtype):
    assert select_ssd_variant(P, N, dtype) == "cuda_core"


@pytest.mark.parametrize("lib", LIBRARIES, ids=lambda lib: lib.name)
def test_every_variant_has_its_entry_point(lib):
    """Each variant's C symbol is defined, ``extern "C"``, in its source, and
    the count of launches is the sum of the variants' counts."""
    source = lib.source.read_text()
    for variant, (entry, argtypes) in lib.variants.items():
        assert re.search(rf'extern "C" int {entry}\(', source), (lib.name, variant, entry)
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', source).group(1)
        assert len(params.split(",")) == len(argtypes), (entry, params)
    saved = dict(lib.counts)
    try:
        lib.counts = {v: i + 1 for i, v in enumerate(lib.variants)}
        assert lib.launches == sum(range(1, len(lib.variants) + 1))
        lib.reset()
        assert lib.launches == 0 and set(lib.counts) == set(lib.variants)
    finally:
        lib.counts = saved


def test_variant_names():
    assert set(SWIGLU_LIBRARY.variants) == {"wgmma", "decode", "cuda_core", "experts_wgmma",
                                            "experts_decode", "experts_cuda_core", "wgmma_bwd",
                                            "experts_wgmma_bwd"}
    assert set(FLASH_LIBRARY.variants) == {"mma", "cuda_core", "wgmma_bwd"}
    assert set(SSD_LIBRARY.variants) == {"wgmma", "cuda_core", "wgmma_bwd"}
    assert set(CONV_LIBRARY.variants) == {"fwd", "bwd", "bwd_reduce"}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M", [8, 64, 79])
def test_cpu_tensors_launch_nothing(dtype, M):
    """CPU tensors take the plain versions at every shape the selectors
    would send to a tensor-core kernel on the card: no count moves."""
    before = {lib.name: dict(lib.counts) for lib in LIBRARIES}
    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, 64, generator=g).to(dtype)
    w = (torch.randn(64, 96, generator=g) / 8).to(dtype)
    swiglu_matmul(x, w, w)
    fused_swiglu(x[None], w, w)
    swiglu_experts(x[None].expand(3, M, 64), w[None].expand(3, 64, 96), w[None].expand(3, 64, 96))
    flash_attention(torch.randn(2, M, 192, generator=g).to(dtype),
                    torch.randn(2, M, 192, generator=g).to(dtype),
                    torch.randn(2, M, 128, generator=g).to(dtype), causal=True)
    q = torch.randn(2, M, 64, generator=g).to(dtype)
    flash_attention(q, q, q, causal=True)
    gqa_flash_attention(q.reshape(1, 2, M, 64).movedim(1, 2), q[:1, :, None].expand(1, M, 1, 64),
                        q[:1, :, None].expand(1, M, 1, 64))
    gqa_bidirectional_attention(q.reshape(1, 2, M, 64).movedim(1, 2),
                                q[:1, :, None].expand(1, M, 1, 64),
                                q[:1, :, None].expand(1, M, 1, 64))
    # the SSD scan at the wgmma variant's widths (head dim 64, state 128)
    dt = torch.rand(2, M, generator=g)
    B = torch.randn(2, M, 128, generator=g).to(dtype)
    ssd_scan(q, dt, -torch.ones(2), B, B, return_state=True)
    ssd_mixer(q.movedim(0, 1)[None], dt.T[None], -torch.ones(2), B[:1, :, None], B[:1, :, None])
    # the causal conv at a width of 8 channels, its window read and written
    window = torch.zeros(2, 3, 64, dtype=dtype)
    causal_conv(q, w[:4, :64], w[4, :64], window, window)
    assert {lib.name: dict(lib.counts) for lib in LIBRARIES} == before
