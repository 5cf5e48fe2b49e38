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
  16-byte copies need 16-byte row strides); any M, D, F.  FFMA on the CUDA
  cores, in IEEE f32, fed by a ring of shared-memory stages.  Two load paths, picked from the operands before the launch: the
  fast one (f32, F a multiple of 4, wg, wu and out on 16-byte boundaries)
  copies the weights 16 bytes at a time by ``cp.async`` and x 4 bytes at a
  time, transposed on the way in; the general one (any other f32 call, and
  bf16) loads element by element and converts to f32.  Three tile classes
  (``CUDA_CORE_CLASSES``): ``small`` for M <= ``CUDA_CORE_SMALL_M``, bound
  by the weights' bytes, else ``r64`` or ``r128``, whichever a wave-count
  model over the card's SMs prefers (:func:`cuda_core_plan`, which repeats
  the C side's choice).

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
kernel has no custom VJP (its model trains through plain einsums); the
port's backward of either entry is a kernel where the shapes allow it:
:func:`select_bwd_variant` picks ``wgmma_bwd`` (``experts_wgmma_bwd``) for
every bf16 call whose D and F are multiples of 8, at any M: the ``wgmma``
kernel's mainloop recomputes g = x wg and u = x wu and its backward
epilogue writes dg and du (:func:`ref.swiglu_bwd_ref`); the wrapper then
forms dx = dg wgᵀ + du wuᵀ, dwg = xᵀ dg, dwu = xᵀ du as plain products
(:func:`swiglu_grads`, counted as ``("swiglu_matmul", "vjp")``).  Other
calls (f32; D or F not a multiple of 8) get ``"vjp"``: :func:`swiglu_vjp`,
the same derivative in PyTorch.  The choice is made from the shapes and
the dtype before anything launches; nothing falls back from a failed
launch.  The kernel records its :func:`work_bwd` as ``("swiglu_matmul",
"wgmma_bwd")``; on ``meta`` it returns empty dg and du and counts the
launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import swiglu_derivative, swiglu_experts_ref, swiglu_ref

__all__ = ["swiglu_matmul", "swiglu_experts", "swiglu_vjp", "swiglu_grads", "select_variant",
           "select_experts_variant", "select_bwd_variant", "cuda_core_plan", "work", "work_bwd",
           "LIBRARY", "PREFILL_MIN_M", "CUDA_CORE_CLASSES", "CUDA_CORE_SMALL_M"]

PREFILL_MIN_M = 64  # rows from which the bf16 product is bound by operations
# The CUDA-core kernel's tile classes (csrc/swiglu_matmul.cu, namespace
# simt), in the order of their C index, as its C function
# swiglu_cuda_core_layout gives them (a card test holds the two equal): rows
# and columns of a CTA's tile, k rows of a stage, k groups (whose partial sums
# are added in group order), threads, the CTAs an SM it is built for, and the
# stages of its ring.
CUDA_CORE_CLASSES = {
    "small": dict(bm=16, bn=32, bk=32, ksplit=4, threads=128, ctas=4, stages=4),
    "r64": dict(bm=64, bn=64, bk=8, ksplit=1, threads=64, ctas=6, stages=4),
    "r128": dict(bm=128, bn=64, bk=8, ksplit=1, threads=128, ctas=3, stages=4),
}
CUDA_CORE_SMALL_M = 16  # rows up to which the small class runs
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
    # x, wg, wu, dout, dg, du, M, D, F, stream
    "wgmma_bwd": ("swiglu_matmul_wgmma_bwd", [_P] * 6 + [_I, _I, _I, _P]),
    # x, wg, wu, dout, dg, du, E, M, D, F, stream
    "experts_wgmma_bwd": ("swiglu_experts_wgmma_bwd", [_P] * 6 + [_I, _I, _I, _I, _P]),
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


def select_bwd_variant(M: int, D: int, F: int, dtype: torch.dtype, experts: bool = False) -> str:
    """The backward a CUDA call of these shapes and dtype runs (of
    :func:`swiglu_experts` with ``experts``): the ``wgmma_bwd`` kernel
    (``experts_wgmma_bwd``) for bf16 with D and F multiples of 8, at any M;
    otherwise ``"vjp"`` (:func:`swiglu_vjp`)."""
    if dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0:
        return "experts_wgmma_bwd" if experts else "wgmma_bwd"
    return "vjp"


def cuda_core_plan(E: int, M: int, D: int, F: int, dtype: torch.dtype, aligned: bool = True,
                   sms: int = 132) -> tuple:
    """(tile class, load path) of a ``cuda_core`` / ``experts_cuda_core``
    call of E products of M rows (E = 1: one product) on a card with ``sms``
    SMs, as the C side (``swiglu_cuda_core_plan``) picks them before the
    launch.  ``aligned``: wg, wu and out start on 16-byte boundaries.

    The class: ``small`` for M <= ``CUDA_CORE_SMALL_M``; else ``r64`` or
    ``r128``, whichever costs less in a wave-count model, ``r128`` on a tie.
    A wave is one CTA on each of a class's ``ctas`` slots of every SM and
    takes as long as an SM needs for ``ctas`` tiles' outputs; the call's
    tiles take ceil(tiles / (sms ctas)) waves.  The path: ``fast`` for f32
    with F a multiple of 4 and aligned operands (x goes 4 bytes at a time,
    so D is free), else ``general``."""
    if min(E, M, D, F) <= 0 or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"no CUDA-core plan for E={E} M={M} D={D} F={F} {dtype}")
    path = "fast" if dtype == torch.float32 and F % 4 == 0 and aligned else "general"
    if M <= CUDA_CORE_SMALL_M:
        return "small", path

    def cost(c):
        tiles = E * -(-M // c["bm"]) * -(-F // c["bn"])
        return -(-tiles // (sms * c["ctas"])) * c["ctas"] * c["bm"] * c["bn"]
    r64, r128 = CUDA_CORE_CLASSES["r64"], CUDA_CORE_CLASSES["r128"]
    return ("r64" if cost(r64) < cost(r128) else "r128"), path


def work(M: int, D: int, F: int, elem: int, E: int = 1) -> tuple:
    """(operations, bytes) of E products of M rows (E = 1: one product):
    operations 2 per multiply-add of both x·wg and x·wu; bytes x and both
    weights read once and the output written once, ``elem`` bytes an
    element."""
    return 4.0 * E * M * D * F, E * (M * D + 2 * D * F + M * F) * elem


def work_bwd(M: int, D: int, F: int, elem: int, E: int = 1) -> tuple:
    """(operations, bytes) of E backward kernel calls of M rows: operations
    the two recomputed products (as :func:`work`); bytes x, both weights and
    dout read once, dg and du written once."""
    return 4.0 * E * M * D * F, E * (M * D + 2 * D * F + 3 * M * F) * elem


def swiglu_grads(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dg: torch.Tensor,
                 du: torch.Tensor):
    """(dx, dwg, dwu) from dg and du: dx = dg wgᵀ + du wuᵀ, dwg = xᵀ dg,
    dwu = xᵀ du, as ``torch.matmul`` in the operands' dtype (one product or
    a leading expert dim)."""
    dx = torch.matmul(dg, wg.transpose(-1, -2)) + torch.matmul(du, wu.transpose(-1, -2))
    xt = x.transpose(-1, -2)
    return dx.to(x.dtype), torch.matmul(xt, dg).to(wg.dtype), torch.matmul(xt, du).to(wu.dtype)


def swiglu_vjp(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dout: torch.Tensor):
    """(dx, dwg, dwu) of out = silu(x wg) ⊙ (x wu) at the cotangent ``dout``,
    in the inputs' dtypes, for x [M, D] and wg, wu [D, F], or for a leading
    expert dim (x [E, M, D], wg, wu [E, D, F]): g = x wg and u = x wu
    recomputed as ``torch.matmul`` in the operands' dtype (cuBLAS
    accumulates bf16 in f32 and rounds the result to bf16, as the
    reference's einsums do), :func:`ref.swiglu_derivative` in f32 (f64 for
    f64 inputs), then :func:`swiglu_grads`."""
    acc = torch.promote_types(x.dtype, torch.float32)
    g, u = torch.matmul(x, wg).to(acc), torch.matmul(x, wu).to(acc)
    dg, du = swiglu_derivative(g, u, dout, x.dtype)
    del g, u
    return swiglu_grads(x, wg, wu, dg, du)


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


def _launch_bwd(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dout: torch.Tensor):
    """Launch ``wgmma_bwd`` (``experts_wgmma_bwd`` for x [E, M, D]): (dg, du)
    of dout's shape and dtype."""
    experts = x.dim() == 3
    name = "swiglu_experts" if experts else "swiglu_matmul"
    check_cuda_operands(name, (x, wg, wu, dout), (torch.bfloat16,))
    *lead, M, D = x.shape
    variant = "experts_wgmma_bwd" if experts else "wgmma_bwd"
    dg, du = torch.empty_like(dout), torch.empty_like(dout)
    if x.is_meta:
        LIBRARY.account(variant)
        return dg, du
    check_aligned(name, (x, wg, wu, dout))
    LIBRARY.launch(variant, *(t.data_ptr() for t in (x, wg, wu, dout, dg, du)), *lead, M, D,
                   wg.shape[-1], stream_handle(x))
    return dg, du


class _SwiGLU(torch.autograd.Function):
    """Either entry's launch forward; backward the ``wgmma_bwd`` launch and
    :func:`swiglu_grads`, or :func:`swiglu_vjp`, as :func:`select_bwd_variant`
    picks."""

    @staticmethod
    def forward(ctx, x, wg, wu):
        ctx.save_for_backward(x, wg, wu)
        return _launch(x, wg, wu)

    @staticmethod
    def backward(ctx, dout):
        x, wg, wu = ctx.saved_tensors
        *lead, M, D = x.shape
        F = wg.shape[-1]
        variant = select_bwd_variant(M, D, F, x.dtype, experts=bool(lead))
        if variant == "vjp":
            with uncounted("swiglu_matmul"):
                return swiglu_vjp(x, wg, wu, dout)
        record("swiglu_matmul", variant, work_bwd(M, D, F, x.element_size(), *lead))
        dg, du = _launch_bwd(x, wg, wu, dout.contiguous())
        with uncounted("swiglu_matmul"):
            return swiglu_grads(x, wg, wu, dg, du)


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
