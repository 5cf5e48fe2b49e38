"""Fused SwiGLU matmul: the CUDA kernel ``csrc/swiglu_matmul.cu`` and its
wrapper.

Port of ``repro/kernels/swiglu_matmul.py`` (a Pallas TPU kernel):
``silu(x @ wg) * (x @ wu)`` with both products accumulated in f32 from one
shared x tile and the silu·mul epilogue fused, so the ``[M, F]`` products
never reach device memory.  The source holds three kernels, each with its
own entry point and launch count (``LIBRARY.counts``); the design note is at
the top of the CUDA source.  :func:`select_variant` picks one from the
shapes and the dtype alone:

- ``wgmma``: bf16 prefill (M >= ``PREFILL_MIN_M``), tensor cores fed by TMA;
- ``decode``: bf16 decode (M < ``PREFILL_MIN_M``), a weight stream on
  ``mma.sync`` with K split across a thread-block cluster;
- ``cuda_core``: f32, and bf16 whose D or F is not a multiple of 8 (TMA and
  16-byte copies need 16-byte row strides); any M, D, F.

This is a dispatch by shape between hand-written kernels: nothing catches a
failed build or launch and tries another.  CPU tensors take the plain
version, :func:`ref.swiglu_ref`; CUDA tensors launch a kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels.ref import swiglu_ref

__all__ = ["swiglu_matmul", "select_variant", "LIBRARY", "PREFILL_MIN_M"]

PREFILL_MIN_M = 64  # rows from which the bf16 product is bound by operations
_P, _I = ctypes.c_void_p, ctypes.c_int
_TC_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P]  # x, wg, wu, out, M, D, F, stream
LIBRARY = KernelLibrary("swiglu_matmul", {
    "wgmma": ("swiglu_matmul_wgmma_fwd", _TC_ARGS),
    "decode": ("swiglu_matmul_decode_fwd", _TC_ARGS),
    # x, wg, wu, out, M, D, F, dtype, stream
    "cuda_core": ("swiglu_matmul_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
})


def select_variant(M: int, D: int, F: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes and dtype launches."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "wgmma" if M >= PREFILL_MIN_M else "decode"
    return "cuda_core"


def swiglu_matmul(
    x: torch.Tensor,   # [M, D]
    wg: torch.Tensor,  # [D, F]
    wu: torch.Tensor,  # [D, F]
) -> torch.Tensor:
    M, D = x.shape
    F = wg.shape[1]
    if wg.shape != (D, F) or wu.shape != (D, F):
        raise ValueError(f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}")
    if x.device.type == "cpu":
        return swiglu_ref(x, wg, wu)
    dtype = check_cuda_operands("swiglu_matmul", (x, wg, wu),
                                (torch.float32, torch.bfloat16))
    out = torch.empty((M, F), dtype=x.dtype, device=x.device)
    variant = select_variant(M, D, F, x.dtype)
    ptrs = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr())
    if variant == "cuda_core":
        LIBRARY.launch(variant, *ptrs, M, D, F, dtype, stream_handle(x))
    else:
        check_aligned("swiglu_matmul", (x, wg, wu))
        LIBRARY.launch(variant, *ptrs, M, D, F, stream_handle(x))
    return out
