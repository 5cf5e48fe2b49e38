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
take the plain version, :func:`ref.flash_attention_ref`, and autograd runs
through it; CUDA tensors launch a kernel or raise.  ``meta`` tensors take
the CUDA route without launching: the ``autograd.Function`` returns an
empty output of the kernel's shape and dtype and counts the launch the
selected variant would make, so that a step can be shape-propagated (and
its backward too).  Every call records its :func:`work` once, at the entry
(``kernels/_work.py``), whichever of the three routes it takes.

On the card the launch sits in a ``torch.autograd.Function``, so the output
has a gradient path whenever an input requires grad.  The reference's
kernel has no custom VJP (its model trains through plain ``jnp``), so there
is no backward kernel to port: the backward is :func:`flash_attention_vjp`,
an explicit VJP in PyTorch that recomputes the probabilities in f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import (
    KernelLibrary, check_aligned, check_cuda_operands, stream_handle,
)
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import NEG_INF, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_vjp", "select_variant", "work", "LIBRARY"]

MAX_HEAD_DIM = 192    # q and k
MAX_V_HEAD_DIM = 128  # v and the output
# f32 elements of one [BH chunk, Sq, Sk] intermediate of the VJP (64 MB)
VJP_CHUNK_ELEMS = 1 << 24
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            sc: float) -> torch.Tensor:
    """Launch the variant :func:`select_variant` picks: o [BH, Sq, Dv]."""
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    dtype = check_cuda_operands("flash_attention", (q, k, v),
                                (torch.float32, torch.bfloat16))
    if D > MAX_HEAD_DIM or Dv > MAX_V_HEAD_DIM:
        raise ValueError(f"flash_attention: head dims {D}/{Dv} > {MAX_HEAD_DIM}/{MAX_V_HEAD_DIM}")
    o = torch.empty((BH, Sq, Dv), dtype=q.dtype, device=q.device)
    variant = select_variant(D, Dv, q.dtype)
    if q.is_meta:
        LIBRARY.account(variant)
        return o
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, Sq, Sk, D, Dv, float(sc),
            int(causal))
    if variant == "cuda_core":
        LIBRARY.launch(variant, *args, dtype, stream_handle(q))
    else:
        check_aligned("flash_attention", (q, k, v))
        LIBRARY.launch(variant, *args, stream_handle(q))
    return o


def flash_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, causal: bool, scale: float):
    """(dq, dk, dv) of o = softmax(q kᵀ · scale) v at the output cotangent
    ``do``, in the inputs' dtypes.  Computed in f32 (f64 for f64 inputs)
    over chunks of BH, so that each ``[chunk, Sq, Sk]`` intermediate holds
    at most ``VJP_CHUNK_ELEMS`` elements:

        S = q kᵀ · scale, masked as the kernel masks it (when causal, key j
        is seen by query i iff j <= i + Sk - Sq);  P = softmax(S);
        dV = Pᵀ dO;  dP = dO Vᵀ;  dS = P ⊙ (dP - rowsum(dO ⊙ O));
        dQ = dS K · scale;  dK = dSᵀ Q · scale.

    ``o`` is the forward's output.  dS is zero under the mask, as autograd
    through the plain version's ``where`` gives it (a row that sees no key
    has a uniform P, which only dV reads)."""
    BH, Sq, _ = q.shape
    Sk = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)
    mask = None
    if causal:
        kpos = torch.arange(Sk, device=q.device)
        qpos = torch.arange(Sq, device=q.device)
        mask = kpos[None, :] <= (qpos[:, None] + (Sk - Sq))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    step = max(1, VJP_CHUNK_ELEMS // max(Sq * Sk, 1))
    for b0 in range(0, BH, step):
        sl = slice(b0, b0 + step)
        qc, kc, vc, oc, doc = (t[sl].to(acc) for t in (q, k, v, o, do))
        s = torch.bmm(qc, kc.transpose(1, 2)) * scale
        if mask is not None:
            s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[sl] = torch.bmm(p.transpose(1, 2), doc)
        dp = torch.bmm(doc, vc.transpose(1, 2))
        ds = p * (dp - (doc * oc).sum(-1, keepdim=True))
        del p, dp
        if mask is not None:
            ds = torch.where(mask, ds, 0.0)
        dq[sl] = torch.bmm(ds, kc) * scale
        dk[sl] = torch.bmm(ds.transpose(1, 2), qc) * scale
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel's launch forward, :func:`flash_attention_vjp` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sc: float):
        o = _launch(q, k, v, causal, sc)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.sc = causal, sc
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with uncounted("flash_attention"):
            dq, dk, dv = flash_attention_vjp(q, k, v, o, do, ctx.causal, ctx.sc)
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
