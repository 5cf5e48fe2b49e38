"""The Mamba-2 mixer's causal conv, bias and SiLU in one pass: the CUDA
kernels ``csrc/causal_conv.cu`` and their wrapper.

The JAX package has no kernel for this (``repro/models/ssm.py::_causal_conv``
is jnp, which XLA fuses); the port ran it as ~23 eager f32 passes forward and
~39 backward a layer, the largest share of mamba2's training step.  The
source's three kernels each count their launches (``LIBRARY.counts``):

- ``fwd``: ``silu(Σ_i concat(carry, x)[t + i] · w_i + b)`` over x [B, S, CH]
  with taps w [4, CH] and bias b [CH], in f32 in the plain version's order,
  written in x's dtype.  With ``carry`` [B, 3, CH] (the 3 positions before
  x) it reads that history, and with ``carry_out`` it writes the new window,
  the last 3 positions of carry + x, in place: decode passes the cache's own
  window as both, prefill the cache's window as ``carry_out`` alone.
- ``bwd`` and ``bwd_reduce``, the backward (no carry): dx, and each CTA's
  partial sums of dw and db in a scratch whose size the source gives
  (``conv_silu_bwd_scratch_floats``), then their sum in a fixed order.

CPU tensors take the plain version, :func:`ref.causal_conv_ref` (the eager
passes the model ran before), and autograd runs through it; CUDA tensors
launch the kernels or raise; ``meta`` tensors take the CUDA route without
launching and count the launches the card would make.  On the card a call
that needs a gradient goes through :class:`_ConvSiLU`, an
``autograd.Function`` whose backward is the two backward kernels; a call that
does not (serving) launches the forward directly.  Every call records its
:func:`work` once, at the entry (``kernels/_work.py``), and each backward
its two kernels' (:func:`work_bwd`, :func:`work_reduce`): one record a
launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import causal_conv_ref

__all__ = ["causal_conv", "work", "work_bwd", "work_reduce", "LIBRARY", "WIDTH"]

WIDTH = 4  # the taps the kernels take (every registry config's conv_width)
BWD_CTA_ROWS = 128  # time rows a backward CTA covers: 8 runs of 16 (csrc/causal_conv.cu)
_P, _I = ctypes.c_void_p, ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)  # in the order of the C side's dtype codes
LIBRARY = KernelLibrary("causal_conv", {
    # x, w, b, carry_in, carry_out, out, batch, S, CH, dtype, carry dtype, stream
    "fwd": ("conv_silu_fwd", [_P] * 6 + [_I] * 5 + [_P]),
    # x, w, b, dy, dx, part, batch, S, CH, dtype, stream
    "bwd": ("conv_silu_bwd", [_P] * 6 + [_I] * 4 + [_P]),
    # part, dw, db, batch, S, CH, w dtype, stream
    "bwd_reduce": ("conv_silu_bwd_reduce", [_P] * 3 + [_I] * 4 + [_P]),
})


def work(B: int, S: int, CH: int, elem: int, carry_elem: int = 0,
         reads_carry: bool = False, writes_carry: bool = False) -> tuple:
    """(operations, bytes) of one forward over x [B, S, CH].  Operations, an
    element: the taps' 4 multiply-adds (2 each), the bias, and SiLU's negate,
    exp, add and divide.  Bytes: x read and the output written, the taps and
    the bias read, in the input type (``elem`` bytes); the carry's window read
    and the new one written where the call does, in ``carry_elem`` bytes."""
    windows = (int(reads_carry) + int(writes_carry)) * B * (WIDTH - 1) * CH * carry_elem
    return float(B * S * CH * (2 * WIDTH + 5)), 2 * B * S * CH * elem + (WIDTH + 1) * CH * elem \
        + windows


def work_bwd(B: int, S: int, CH: int, elem: int, w_elem: int) -> tuple:
    """(operations, bytes) of one backward over [B, S, CH].  Operations, an
    element: the forward's pre-activation and SiLU recomputed (13), SiLU's
    derivative (5), dx's and the taps' gradients' 4 multiply-adds each (2
    each) and the bias gradient's add.  Bytes: x and dy read and dx written,
    the taps and bias read, in the input type; dw and db written in the
    taps' type (``w_elem``).  The partial sums between the two kernels are
    :func:`work_reduce`'s."""
    ops = float(B * S * CH * ((2 * WIDTH + 5) + 5 + 2 * (2 * WIDTH) + 1))
    return ops, 3 * B * S * CH * elem + (WIDTH + 1) * CH * (elem + w_elem)


def work_reduce(B: int, S: int, CH: int, w_elem: int) -> tuple:
    """(operations, bytes) of ``bwd_reduce``, the sum of the backward's
    partials: one f32 partial of dw and db (WIDTH + 1 rows of CH) for each
    CTA along batch and time, read once; dw and db written in the taps' type."""
    n = B * -(-S // BWD_CTA_ROWS) * (WIDTH + 1) * CH
    return n, n * 4 + (WIDTH + 1) * CH * w_elem


def _check(x, w, b, carry, carry_out):
    """The wrapper's checks of a CUDA or ``meta`` call; returns (the dtype
    code of x, w, b; that of the carry window)."""
    dtype = check_cuda_operands("causal_conv", (x, w, b), _DTYPES)
    B, S, CH = x.shape
    if w.shape != (WIDTH, CH) or b.shape != (CH,):
        raise ValueError(f"causal_conv: taps {tuple(w.shape)} and bias {tuple(b.shape)} for "
                         f"x {tuple(x.shape)}: the kernels take {WIDTH} taps")
    windows = [c for c in (carry, carry_out) if c is not None]
    for c in windows:
        if c.shape != (B, WIDTH - 1, CH) or not c.is_contiguous() or c.device != x.device:
            raise ValueError(f"causal_conv: carry {tuple(c.shape)} on {c.device} for x "
                             f"{tuple(x.shape)} on {x.device} (contiguous [B, {WIDTH - 1}, CH])")
        if c.dtype not in _DTYPES or c.dtype != windows[0].dtype:
            raise ValueError(f"causal_conv: carry windows of {[t.dtype for t in windows]}")
    if carry is not None and carry.requires_grad:
        raise ValueError("causal_conv: the kernels' backward takes no carry")
    return dtype, _DTYPES.index(windows[0].dtype) if windows else 0


def _launch(x, w, b, carry=None, carry_out=None):
    """The forward kernel: silu(conv + b) [B, S, CH] in x's dtype; the new
    window written into ``carry_out`` where given."""
    dtype, carry_dtype = _check(x, w, b, carry, carry_out)
    B, S, CH = x.shape
    out = torch.empty_like(x)
    if x.is_meta:
        LIBRARY.account("fwd")
        return out
    LIBRARY.launch("fwd", x.data_ptr(), w.data_ptr(), b.data_ptr(),
                   None if carry is None else carry.data_ptr(),
                   None if carry_out is None else carry_out.data_ptr(), out.data_ptr(),
                   B, S, CH, dtype, carry_dtype, stream_handle(x))
    return out


def _launch_bwd(x, w, b, dy):
    """The backward kernels at the cotangent dy of the output: (dx, dw, db)
    in the dtypes of x, w and b."""
    dtype = check_cuda_operands("causal_conv", (x, w, b, dy), _DTYPES)
    B, S, CH = x.shape
    dx, dw, db = torch.empty_like(x), torch.empty_like(w), torch.empty_like(b)
    if x.is_meta:
        LIBRARY.account("bwd")
        LIBRARY.account("bwd_reduce")
        return dx, dw, db
    part = torch.empty(LIBRARY.size("conv_silu_bwd_scratch_floats", B, S, CH),
                       dtype=torch.float32, device=x.device)
    stream = stream_handle(x)
    LIBRARY.launch("bwd", x.data_ptr(), w.data_ptr(), b.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                   part.data_ptr(), B, S, CH, dtype, stream)
    LIBRARY.launch("bwd_reduce", part.data_ptr(), dw.data_ptr(), db.data_ptr(), B, S, CH,
                   _DTYPES.index(w.dtype), stream)
    return dx, dw, db


class _ConvSiLU(torch.autograd.Function):
    """The forward kernel; backward the two backward kernels, which recompute
    the pre-activation from x (nothing but the inputs is saved).  A call with
    a carry read writes its window over that carry in place, so nothing the
    backward would need survives it: its backward raises."""

    @staticmethod
    def forward(ctx, x, w, b, carry, carry_out):
        ctx.save_for_backward(x, w, b)
        ctx.read_carry = carry is not None
        return _launch(x, w, b, carry, carry_out)

    @staticmethod
    def backward(ctx, dy):
        if ctx.read_carry:
            raise RuntimeError("causal_conv: no backward through a call that read a carry")
        x, w, b = ctx.saved_tensors
        B, S, CH = x.shape
        record("causal_conv", "bwd", work_bwd(B, S, CH, x.element_size(), w.element_size()))
        record("causal_conv", "bwd_reduce", work_reduce(B, S, CH, w.element_size()))
        return (*_launch_bwd(x, w, b, dy.contiguous()), None, None)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                carry: Optional[torch.Tensor] = None,
                carry_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """silu(depthwise causal conv of x [B, S, CH] with taps w [W, CH] + bias b
    [CH]) in x's dtype.  ``carry`` [B, W - 1, CH]: the positions before x
    (zeros without).  ``carry_out`` [B, W - 1, CH]: written in place with the
    last W - 1 positions of carry + x (it may be ``carry`` itself)."""
    B, S, CH = x.shape
    carry_elem = next((c.element_size() for c in (carry, carry_out) if c is not None), 0)
    record("causal_conv", "fwd", work(B, S, CH, x.element_size(), carry_elem,
                                      carry is not None, carry_out is not None))
    if x.device.type == "cpu":
        with uncounted():
            out, window = causal_conv_ref(x, w, b, carry)
            if carry_out is not None:
                carry_out.copy_(window)
        return out
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _ConvSiLU.apply(x, w, b, carry, carry_out)
    return _launch(x, w, b, carry, carry_out)
