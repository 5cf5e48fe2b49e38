"""Flash attention forward: the CUDA kernel ``csrc/flash_attention.cu`` and
its wrapper.

Port of ``repro/kernels/flash_attention.py`` (a Pallas TPU kernel).  The
Pallas grid's sequential KV axis, with the online-softmax state carried in
VMEM scratch, becomes a loop over shared-memory K/V tiles inside one CUDA
thread block per (batch·head, 64-row query tile); the design note is at the
top of the CUDA source.  The kernels mask ragged sequence ends themselves,
so they take any ``Sq``/``Sk``; the reference's block divisibility is a
property of the TPU grid and is kept by the padding in
``ops.gqa_flash_attention``.

The value head dim ``Dv`` may differ from the query/key head dim ``D``
(MLA's prefill: D = 192, Dv = 128).  The source holds two kernels, each with
its own entry point and launch count (``LIBRARY.counts``);
:func:`select_variant` picks one from the head dims and the dtype alone:
``mma`` (bf16, D a multiple of 16 up to 192 and Dv one up to 128: tensor
cores) or ``cuda_core`` (f32, and bf16 with other head dims).
Nothing catches a failed build or launch and tries another.  CPU tensors
take the plain version, :func:`ref.flash_attention_ref`; CUDA tensors launch
a kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "select_variant", "LIBRARY"]

MAX_HEAD_DIM = 192    # q and k
MAX_V_HEAD_DIM = 128  # v and the output
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary("flash_attention", {
    # q, k, v, o, bh, sq, sk, d, dv, scale, causal, stream
    "mma": ("flash_attention_mma_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # q, k, v, o, bh, sq, sk, d, dv, scale, causal, dtype, stream
    "cuda_core": ("flash_attention_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
})


def select_variant(D: int, Dv: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with q/k head dim ``D``, v head dim ``Dv`` and
    ``dtype`` launches."""
    if (dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0 and D <= MAX_HEAD_DIM
            and Dv <= MAX_V_HEAD_DIM):
        return "mma"
    return "cuda_core"


def flash_attention(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Sk, D]
    v: torch.Tensor,  # [BH, Sk, Dv]
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale) v: [BH, Sq, Dv] in q's dtype; ``scale``
    defaults to D^-0.5."""
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    if k.shape != (BH, Sk, D) or v.shape != (BH, Sk, Dv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    sc = scale if scale is not None else D ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=sc)
    dtype = check_cuda_operands("flash_attention", (q, k, v),
                                (torch.float32, torch.bfloat16))
    if D > MAX_HEAD_DIM or Dv > MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}/{Dv} > {MAX_HEAD_DIM}/{MAX_V_HEAD_DIM}")
    o = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
    variant = select_variant(D, Dv, q.dtype)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, Sq, Sk, D, Dv, float(sc),
            int(causal))
    if variant == "cuda_core":
        LIBRARY.launch(variant, *args, dtype, stream_handle(q))
    else:
        check_aligned("flash_attention", (q, k, v))
        LIBRARY.launch(variant, *args, stream_handle(q))
    return o
