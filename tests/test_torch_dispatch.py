"""Which hand-written kernel a CUDA call of the port launches.

``swiglu_matmul``, ``flash_attention`` and ``ssd_scan`` each hold several
CUDA kernels; their wrappers pick one by a pure function of the shapes and
the dtype (``select_variant``), which these tests hold on the CPU: the
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
    FLASH_LIBRARY, LIBRARIES, SSD_LIBRARY, SWIGLU_LIBRARY, flash_attention, fused_swiglu,
    gqa_flash_attention, select_flash_variant, select_ssd_variant, select_swiglu_variant,
    ssd_mixer, ssd_scan, swiglu_matmul,
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
    assert select_flash_variant(HEAD_DIM, BF16) == "mma"


@pytest.mark.parametrize("D", [16, 32, 48, 64, 80, 96, 112, 128])
def test_flash_head_dims_on_tensor_cores(D):
    assert select_flash_variant(D, BF16) == "mma"


@pytest.mark.parametrize("D,dtype", [(64, F32), (128, F32), (8, BF16), (40, BF16), (72, BF16),
                                     (100, BF16), (144, BF16)])
def test_flash_other_head_dims_take_cuda_cores(D, dtype):
    assert select_flash_variant(D, dtype) == "cuda_core"


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
    assert set(SWIGLU_LIBRARY.variants) == {"wgmma", "decode", "cuda_core"}
    assert set(FLASH_LIBRARY.variants) == {"mma", "cuda_core"}
    assert set(SSD_LIBRARY.variants) == {"wgmma", "cuda_core"}


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
    q = torch.randn(2, M, 64, generator=g).to(dtype)
    flash_attention(q, q, q, causal=True)
    gqa_flash_attention(q.reshape(1, 2, M, 64).movedim(1, 2), q[:1, :, None].expand(1, M, 1, 64),
                        q[:1, :, None].expand(1, M, 1, 64))
    # the SSD scan at the wgmma variant's widths (head dim 64, state 128)
    dt = torch.rand(2, M, generator=g)
    B = torch.randn(2, M, 128, generator=g).to(dtype)
    ssd_scan(q, dt, -torch.ones(2), B, B, return_state=True)
    ssd_mixer(q.movedim(0, 1)[None], dt.T[None], -torch.ones(2), B[:1, :, None], B[:1, :, None])
    assert {lib.name: dict(lib.counts) for lib in LIBRARIES} == before
