"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its wrapper.

Port of ``repro/kernels/flash_attention.py`` (a Pallas TPU kernel).  The
Pallas grid's sequential KV axis, with the online-softmax state carried in
VMEM scratch, becomes a loop over shared-memory K/V tiles inside one CUDA
thread block per (batch·head, 64-row query tile); the design note is at the
top of the CUDA source.  The kernel masks ragged sequence ends itself, so it
takes any ``Sq``/``Sk``; the reference's block divisibility is a property of
the TPU grid and is kept by the padding in ``ops.gqa_flash_attention``.

CPU tensors take the plain version, :func:`ref.flash_attention_ref`; CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "LIBRARY"]

MAX_HEAD_DIM = 128
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary(
    "flash_attention",
    # q, k, v, o, bh, sq, sk, d, scale, causal, dtype, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
)


def flash_attention(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Sk, D]
    v: torch.Tensor,  # [BH, Sk, D]
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if k.shape != (BH, Sk, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    sc = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=sc)
    dtype = check_cuda_operands("flash_attention", (q, k, v),
                                (torch.float32, torch.bfloat16))
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    o = torch.empty_like(q)
    LIBRARY.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                   BH, Sq, Sk, D, float(sc), int(causal), dtype, stream_handle(q))
    return o
