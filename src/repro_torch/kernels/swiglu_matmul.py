"""Fused SwiGLU matmul: the CUDA kernel ``csrc/swiglu_matmul.cu`` and its
wrapper.

Port of ``repro/kernels/swiglu_matmul.py`` (a Pallas TPU kernel):
``silu(x @ wg) * (x @ wu)`` with both products accumulated in f32 from one
shared x tile and the silu·mul epilogue fused, so the ``[M, F]`` products
never reach device memory.  The design note is at the top of the CUDA
source.  The kernel masks ragged edges itself and takes any M, D, F.

CPU tensors take the plain version, :func:`ref.swiglu_ref`; CUDA tensors
launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels.ref import swiglu_ref

__all__ = ["swiglu_matmul", "LIBRARY"]

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "swiglu_matmul",
    # x, wg, wu, out, M, D, F, dtype, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _P],
)


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
    LIBRARY.launch(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(),
                   M, D, F, dtype, stream_handle(x))
    return out
