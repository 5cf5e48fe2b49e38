"""Chunked Mamba-2 SSD scan: the CUDA kernel ``csrc/ssd_scan.cu`` and its
wrapper.

Port of ``repro/kernels/ssd_scan.py`` (a Pallas TPU kernel).  The Pallas
grid's sequential chunk axis, with the f32 state ``h [P, N]`` carried in VMEM
scratch, becomes a loop over chunks inside one CUDA thread block per
(batch·head, 16-row tile of P); the design note is at the top of the CUDA
source.  The kernel's chunk length is its own (32) and it masks a ragged end
itself, so it takes any ``S``: the reference's ``S % block_s == 0`` is a
property of the TPU grid, and nothing pads for it.

Unlike the Pallas kernel it can also return the final state (f32), which a
prefill needs for its cache.  CPU tensors take the plain version,
:func:`ref.ssd_scan_ref`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels.ref import ssd_scan_ref

__all__ = ["ssd_scan", "LIBRARY"]

MAX_STATE = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("ssd_scan", {
    # x, dt, A, B, C, y, h_out, BH, S, P, N, dtype, stream
    "cuda_core": ("ssd_scan_fwd", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
})


def ssd_scan(
    x: torch.Tensor,   # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]   (f32, post-softplus)
    A: torch.Tensor,   # [BH]      (f32, negative)
    B: torch.Tensor,   # [BH, S, N]
    C: torch.Tensor,   # [BH, S, N]
    return_state: bool = False,
):
    """y [BH, S, P] in x's dtype; with ``return_state`` also the final state
    h [BH, P, N] in f32."""
    BH, S, P = x.shape
    N = B.shape[-1]
    if dt.shape != (BH, S) or A.shape != (BH,) or B.shape != (BH, S, N) or C.shape != B.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}")
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, return_state=return_state)
    dtype = check_cuda_operands("ssd_scan", (x, B, C), (torch.float32, torch.bfloat16))
    check_cuda_operands("ssd_scan", (dt, A), (torch.float32,))
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: operands on {x.device} and {dt.device}")
    if N > MAX_STATE or N % 4:
        raise ValueError(f"ssd_scan: state width {N} is not a multiple of 4 up to {MAX_STATE}")
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device) if return_state else None
    LIBRARY.launch("cuda_core", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                   BH, S, P, N, dtype, stream_handle(x))
    return (y, h) if return_state else y
