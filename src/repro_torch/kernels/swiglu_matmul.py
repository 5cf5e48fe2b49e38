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

:func:`swiglu_experts` computes ``out[e] = silu(x[e] @ wg[e]) * (x[e] @
wu[e])`` for ``x [E, M, D]`` and ``wg, wu [E, D, F]`` in one launch: the
routed experts of a MoE layer.  Each of the three kernels has an expert
entry with its own launch count (``experts_wgmma``, ``experts_decode``,
``experts_cuda_core``), picked by :func:`select_experts_variant` from the
rows an expert (M), D, F and the dtype, as for one product.

This is a dispatch by shape between hand-written kernels: nothing catches a
failed build or launch and tries another.  CPU tensors take the plain
versions, :func:`ref.swiglu_ref` and :func:`ref.swiglu_experts_ref`, and
autograd runs through them; CUDA tensors launch a kernel or raise.
``meta`` tensors take the CUDA route without launching: the
``autograd.Function`` returns an empty output and counts the launch the
selected variant would make.  Every call records its :func:`work` once, at
the entry (``kernels/_work.py``), whichever of the three routes it takes.

On the card each launch sits in a ``torch.autograd.Function``, so the output
has a gradient path whenever an input requires grad.  The reference's
kernel has no custom VJP (its model trains through plain einsums), so there
is no backward kernel to port: the backward of both entries is
:func:`swiglu_vjp`, an explicit VJP in PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import swiglu_experts_ref, swiglu_ref

__all__ = ["swiglu_matmul", "swiglu_experts", "swiglu_vjp", "select_variant",
           "select_experts_variant", "work", "LIBRARY", "PREFILL_MIN_M"]

PREFILL_MIN_M = 64  # rows from which the bf16 product is bound by operations
_P, _I = ctypes.c_void_p, ctypes.c_int
_TC_ARGS = [_P, _P, _P, _P, _I, _I, _I, _P]  # x, wg, wu, out, M, D, F, stream
_EXPERT_TC_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _P]  # x, wg, wu, out, E, M, D, F, stream
LIBRARY = KernelLibrary("swiglu_matmul", {
    "wgmma": ("swiglu_matmul_wgmma_fwd", _TC_ARGS),
    "decode": ("swiglu_matmul_decode_fwd", _TC_ARGS),
    # x, wg, wu, out, M, D, F, dtype, stream
    "cuda_core": ("swiglu_matmul_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "experts_wgmma": ("swiglu_experts_wgmma_fwd", _EXPERT_TC_ARGS),
    "experts_decode": ("swiglu_experts_decode_fwd", _EXPERT_TC_ARGS),
    # x, wg, wu, out, E, M, D, F, dtype, stream
    "experts_cuda_core": ("swiglu_experts_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
})


def select_variant(M: int, D: int, F: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with these shapes and dtype launches."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "wgmma" if M >= PREFILL_MIN_M else "decode"
    return "cuda_core"


def select_experts_variant(M: int, D: int, F: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call of :func:`swiglu_experts` with ``M`` rows an
    expert launches: the expert entry of the kernel one product of that
    shape takes."""
    return "experts_" + select_variant(M, D, F, dtype)


def work(M: int, D: int, F: int, elem: int, E: int = 1) -> tuple:
    """(operations, bytes) of E products of M rows (E = 1: one product):
    operations 2 per multiply-add of both x·wg and x·wu; bytes x and both
    weights read once and the output written once, ``elem`` bytes an
    element."""
    return 4.0 * E * M * D * F, E * (M * D + 2 * D * F + M * F) * elem


def swiglu_vjp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dout: torch.Tensor):
    """(dx, dwg, dwu) of out = silu(x wg) ⊙ (x wu) at the cotangent ``dout``,
    in the inputs' dtypes, for x [M, D] and wg, wu [D, F], or for a leading
    expert dim (x [E, M, D], wg, wu [E, D, F]):

        g = x wg, u = x wu (recomputed);  du = dout ⊙ silu(g);
        dg = dout ⊙ u ⊙ σ(g)(1 + g(1 - σ(g)));
        dx = dg wgᵀ + du wuᵀ;  dwg = xᵀ dg;  dwu = xᵀ du.

    The products are ``torch.matmul`` in the operands' dtype (cuBLAS
    accumulates bf16 in f32 and rounds the result to bf16, as the
    reference's einsums do); the elementwise derivative is f32 (f64 for f64
    inputs)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g = torch.matmul(x, wg).to(acc)
    u = torch.matmul(x, wu).to(acc)
    d = dout.to(acc)
    sig = torch.sigmoid(g)
    du = (d * g * sig).to(x.dtype)
    dg = (d * u * sig * (1 + g * (1 - sig))).to(x.dtype)
    del g, u, d, sig
    dx = torch.matmul(dg, wg.transpose(-1, -2)) + torch.matmul(du, wu.transpose(-1, -2))
    xt = x.transpose(-1, -2)
    return dx.to(x.dtype), torch.matmul(xt, dg).to(wg.dtype), torch.matmul(xt, du).to(wu.dtype)


def _launch(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """Launch the variant the selector picks: [M, F], or [E, M, F] for the
    expert entry (x [E, M, D])."""
    experts = x.dim() == 3
    name = "swiglu_experts" if experts else "swiglu_matmul"
    dtype = check_cuda_operands(name, (x, wg, wu), (torch.float32, torch.bfloat16))
    *lead, M, D = x.shape
    Fd = wg.shape[-1]
    out = torch.empty((*lead, M, Fd), dtype=x.dtype, device=x.device)
    variant = (select_experts_variant if experts else select_variant)(M, D, Fd, x.dtype)
    if x.is_meta:
        LIBRARY.account(variant)
        return out
    args = (x.data_ptr(), wg.data_ptr(), wu.data_ptr(), out.data_ptr(), *lead, M, D, Fd)
    if variant.endswith("cuda_core"):
        LIBRARY.launch(variant, *args, dtype, stream_handle(x))
    else:
        check_aligned(name, (x, wg, wu))
        LIBRARY.launch(variant, *args, stream_handle(x))
    return out


class _SwiGLU(torch.autograd.Function):
    """Either entry's launch forward, :func:`swiglu_vjp` backward."""

    @staticmethod
    def forward(ctx, x, wg, wu):
        ctx.save_for_backward(x, wg, wu)
        return _launch(x, wg, wu)

    @staticmethod
    def backward(ctx, dout):
        with uncounted("swiglu_matmul"):
            return swiglu_vjp(*ctx.saved_tensors, dout)


def swiglu_matmul(
    x: torch.Tensor,   # [M, D]
    wg: torch.Tensor,  # [D, F]
    wu: torch.Tensor,  # [D, F]
) -> torch.Tensor:
    M, D = x.shape
    F = wg.shape[1]
    if wg.shape != (D, F) or wu.shape != (D, F):
        raise ValueError(f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}")
    record("swiglu_matmul", select_variant(M, D, F, x.dtype), work(M, D, F, x.element_size()))
    if x.device.type == "cpu":
        with uncounted():
            return swiglu_ref(x, wg, wu)
    return _SwiGLU.apply(x, wg, wu)


def swiglu_experts(
    x: torch.Tensor,   # [E, M, D]
    wg: torch.Tensor,  # [E, D, F]
    wu: torch.Tensor,  # [E, D, F]
) -> torch.Tensor:
    """``silu(x[e] @ wg[e]) * (x[e] @ wu[e])`` for every expert e: [E, M, F]."""
    E, M, D = x.shape
    F = wg.shape[-1]
    if wg.shape != (E, D, F) or wu.shape != (E, D, F):
        raise ValueError(f"shapes x {tuple(x.shape)}, wg {tuple(wg.shape)}, wu {tuple(wu.shape)}")
    record("swiglu_matmul", select_experts_variant(M, D, F, x.dtype),
           work(M, D, F, x.element_size(), E=E))
    if x.device.type == "cpu":
        with uncounted():
            return swiglu_experts_ref(x, wg, wu)
    return _SwiGLU.apply(x, wg, wu)
