"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_attention.cu`` and their wrapper.

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
take the plain version, :func:`ref.flash_attention_ref`, and autograd runs
through it; CUDA tensors launch a kernel or raise.  ``meta`` tensors take
the CUDA route without launching: the ``autograd.Function`` returns an
empty output of the kernel's shape and dtype and counts the launch the
selected variant would make, so that a step can be shape-propagated (and
its backward too).  Every call records its :func:`work` once, at the entry
(``kernels/_work.py``), whichever of the three routes it takes.

On the card the launch sits in a ``torch.autograd.Function``, so the output
has a gradient path whenever an input requires grad.  The reference's
kernel has no custom VJP (its model trains through plain ``jnp``); the
port's backward is a kernel of its own where the forward is ``mma``:
:func:`select_bwd_variant` picks ``wgmma_bwd`` (from the forward's output
and its per-row logsumexp, which the forward then writes) or, behind the
``cuda_core`` forward (f32, other head dims; no train path on the card takes
it), ``"vjp"``: :func:`flash_attention_vjp`, an explicit VJP in PyTorch that
recomputes the probabilities in f32.  ``wgmma_bwd`` is bound by operations
(five products over the pairs the mask leaves, 2.5x the forward's); it is
Hopper's layout, three kernels in one call: delta (rowsum(dO ⊙ O), with
lse·log2 e, into an f32 scratch whose size the CUDA source gives), dK/dV
(one CTA per 128 keys) and dQ (one per 128 query rows), each two
warpgroups on ``wgmma`` whose first thread also keeps TMA loads in flight
in a ring of stages (no producer warp of its own: it would cap the
registers), S and dP from shared memory and P, dS fed from registers.  dQ recomputes S and dP
in its own kernel, so no sum crosses CTAs and no float atomic is used: the
gradients are the same bits from run to run (the design note is at the top
of the CUDA source).  The choice is made from the head dims and the dtype
before anything launches; a failed build or launch of ``wgmma_bwd`` raises,
nothing tries the VJP instead.  The backward records its :func:`work_bwd`
as ``("flash_attention", "wgmma_bwd")``; on ``meta`` it returns empty
gradients and counts the launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_vjp", "select_variant", "select_bwd_variant",
           "work", "work_bwd", "LIBRARY"]

MAX_HEAD_DIM = 192    # q and k
MAX_V_HEAD_DIM = 128  # v and the output
# f32 elements of one [BH chunk, Sq, Sk] intermediate of the VJP (64 MB)
VJP_CHUNK_ELEMS = 1 << 24
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = KernelLibrary("flash_attention", {
    # q, k, v, o, lse (or null), bh, sq, sk, d, dv, scale, causal, stream
    "mma": ("flash_attention_mma_fwd", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]),
    # q, k, v, o, bh, sq, sk, d, dv, scale, causal, dtype, stream
    "cuda_core": ("flash_attention_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
    # q, k, v, o, do, lse, dq, dk, dv, scratch, bh, sq, sk, d, dv, scale, causal, stream
    "wgmma_bwd": ("flash_attention_wgmma_bwd", [_P] * 10 + [_I, _I, _I, _I, _I, _F, _I, _P]),
})


def select_variant(D: int, Dv: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with q/k head dim ``D``, v head dim ``Dv`` and
    ``dtype`` launches."""
    if (dtype == torch.bfloat16 and D % 16 == 0 and Dv % 16 == 0 and D <= MAX_HEAD_DIM
            and Dv <= MAX_V_HEAD_DIM):
        return "mma"
    return "cuda_core"


def select_bwd_variant(D: int, Dv: int, dtype: torch.dtype) -> str:
    """The backward a CUDA call of these head dims and dtype runs:
    ``"wgmma_bwd"`` (a kernel launch) behind the ``mma`` forward, otherwise
    ``"vjp"`` (:func:`flash_attention_vjp`)."""
    return "wgmma_bwd" if select_variant(D, Dv, dtype) == "mma" else "vjp"


def _causal_pairs(Sq: int, Sk: int) -> int:
    """(query, key) pairs a causal call computes: query i sees keys
    j <= i + Sk - Sq, i.e. min(Sk, max(0, i + Sk - Sq + 1)) of them; the
    largest count, query Sq - 1's, is Sk, so the sum is that of the
    integers from max(1, Sk - Sq + 1) to Sk."""
    lo = max(1, Sk - Sq + 1)
    return (Sk * (Sk + 1) - (lo - 1) * lo) // 2 if Sk >= lo else 0


def work(BH: int, Sq: int, Sk: int, D: int, causal: bool, elem: int,
         Dv: Optional[int] = None) -> tuple:
    """(operations, bytes) of one call: operations 2 per multiply-add of
    QKᵀ over D and PV over Dv for the (query, key) pairs the mask leaves
    (all Sq·Sk when not causal); bytes q, k, v read once and o written
    once, ``elem`` bytes an element.  ``Dv`` defaults to D."""
    Dv = D if Dv is None else Dv
    pairs = _causal_pairs(Sq, Sk) if causal else Sq * Sk
    nbytes = (BH * Sq * D + BH * Sk * D + BH * Sk * Dv + BH * Sq * Dv) * elem
    return 2.0 * BH * pairs * (D + Dv), nbytes


def work_bwd(BH: int, Sq: int, Sk: int, D: int, causal: bool, elem: int,
             Dv: Optional[int] = None) -> tuple:
    """(operations, bytes) of one backward: operations 2.5 times
    :func:`work`'s over the same pairs (five products, S = Q Kᵀ, dP = dO Vᵀ,
    dV, dK and dQ, to the forward's two); bytes q, k, v, o, dO read and dq,
    dk, dv written once, ``elem`` bytes an element, and the f32 lse and
    delta rows read once."""
    Dv = D if Dv is None else Dv
    ops, _ = work(BH, Sq, Sk, D, causal, elem, Dv)
    nbytes = (2 * (BH * Sq * D + BH * Sk * D + BH * Sk * Dv) + 2 * BH * Sq * Dv) * elem
    return 2.5 * ops, nbytes + 2 * BH * Sq * 4


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            sc: float, with_lse: bool = False):
    """Launch the variant :func:`select_variant` picks: (o [BH, Sq, Dv], lse
    [BH, Sq] f32 or None).  ``with_lse`` (the ``mma`` variant only) has the
    kernel write each row's logsumexp for the backward."""
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    dtype = check_cuda_operands("flash_attention", (q, k, v),
                                (torch.float32, torch.bfloat16))
    if D > MAX_HEAD_DIM or Dv > MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}/{Dv} > {MAX_HEAD_DIM}/{MAX_V_HEAD_DIM}")
    o = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
    variant = select_variant(D, Dv, q.dtype)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if with_lse and variant == "mma" else None)
    if q.is_meta:
        LIBRARY.account(variant)
        return o, lse
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    dims = (BH, Sq, Sk, D, Dv, float(sc), int(causal))
    if variant == "cuda_core":
        LIBRARY.launch(variant, *ptrs, *dims, dtype, stream_handle(q))
    else:
        check_aligned("flash_attention", (q, k, v))
        LIBRARY.launch(variant, *ptrs, None if lse is None else lse.data_ptr(), *dims,
                       stream_handle(q))
    return o, lse


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                do: torch.Tensor, lse: torch.Tensor, causal: bool, sc: float):
    """Launch ``wgmma_bwd``: (dq, dk, dv) in the inputs' dtype from the
    forward's o and lse at the cotangent ``do``."""
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    check_cuda_operands("flash_attention", (q, k, v, o, do), (torch.bfloat16,))
    check_cuda_operands("flash_attention", (lse,), (torch.float32,))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.is_meta:
        LIBRARY.account("wgmma_bwd")
        return dq, dk, dv
    check_aligned("flash_attention", (q, k, v, o, do))
    # the f32 lse·log2 e and delta rows, laid out as the CUDA source decides
    scratch = torch.empty(LIBRARY.size("flash_attention_bwd_scratch_floats", BH, Sq),
                          dtype=torch.float32, device=q.device)
    LIBRARY.launch("wgmma_bwd", *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv, scratch)),
                   BH, Sq, Sk, D, Dv, float(sc), int(causal), stream_handle(q))
    return dq, dk, dv


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, causal: bool, scale: float):
    """(dq, dk, dv) of o = softmax(q kᵀ · scale) v at the output cotangent
    ``do``, in the inputs' dtypes, from the forward's output ``o``:
    :func:`ref.flash_attention_bwd_ref` given no lse (it takes the softmax of
    the masked scores; the ``cuda_core`` forward writes none), in f32 (f64 for
    f64 inputs), over chunks of BH, so that each ``[chunk, Sq, Sk]``
    intermediate holds at most ``VJP_CHUNK_ELEMS`` elements."""
    BH, Sq, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    step = max(1, VJP_CHUNK_ELEMS // max(Sq * k.shape[1], 1))
    for b0 in range(0, BH, step):
        sl = slice(b0, b0 + step)
        dq[sl], dk[sl], dv[sl] = flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], None,
                                                         do[sl], causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel's launch forward; backward the ``wgmma_bwd`` launch or
    :func:`flash_attention_vjp`, as :func:`select_bwd_variant` picks."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sc: float):
        bwd = select_bwd_variant(q.shape[-1], v.shape[-1], q.dtype)
        o, lse = _launch(q, k, v, causal, sc,
                         with_lse=bwd == "wgmma_bwd" and any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sc, ctx.bwd = causal, sc, bwd
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.bwd == "vjp":
            with uncounted("flash_attention"):
                dq, dk, dv = flash_attention_vjp(q, k, v, o, do, ctx.causal, ctx.sc)
        else:
            BH, Sq, D = q.shape
            record("flash_attention", ctx.bwd, work_bwd(BH, Sq, k.shape[1], D, ctx.causal,
                                                       q.element_size(), v.shape[-1]))
            dq, dk, dv = _launch_bwd(q, k, v, o, do.contiguous(), lse, ctx.causal, ctx.sc)
        return dq, dk, dv, None, None


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
    record("flash_attention", select_variant(D, Dv, q.dtype),
           work(BH, Sq, Sk, D, causal, q.element_size(), Dv))
    if q.device.type == "cpu":
        with uncounted():
            return flash_attention_ref(q, k, v, causal=causal, scale=sc)
    return _FlashAttention.apply(q, k, v, causal, sc)
