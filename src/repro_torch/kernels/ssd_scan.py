"""Chunked Mamba-2 SSD scan: the CUDA kernels ``csrc/ssd_scan.cu`` and their
wrappers.

Port of ``repro/kernels/ssd_scan.py`` (a Pallas TPU kernel).  The source
holds two variants, each with its own entry point and launch count
(``LIBRARY.counts``); the design notes are at the top of the CUDA source.
:func:`select_variant` picks one from (P, N, dtype) alone:

- ``wgmma``: bf16 with head dim P = 64 and a state width N that is a
  multiple of 16 up to 128 (mamba2-370m's 64/128, jamba's 64/16).  Three
  chunk-parallel kernels on the tensor cores, fed by TMA; one call of the
  wrapper is one launch of the variant, though it enqueues three kernels.
  It reads the mixer's own layout through strides: x ``[B, S, H, P]``, dt
  ``[B, S, H]``, B and C ``[B, S, G, N]`` (head h reads group h // (H/G)),
  so :func:`ssd_mixer` passes the views the model slices from its conv
  output as they are.
- ``cuda_core``: f32, and every other shape.  One block per (batch·head,
  16-row tile of P) walks the chunks in order on the CUDA cores, on flat
  contiguous ``[BH, S, *]`` operands.

Both mask a ragged end themselves, so they take any ``S``: the reference's
``S % block_s == 0`` is a property of the TPU grid, and nothing pads for it.
Unlike the Pallas kernel they can also return the final state (f32), which a
prefill needs for its cache.  CPU tensors take the plain version,
:func:`ref.ssd_scan_ref`, and autograd runs through it; CUDA tensors launch
the selected variant or raise.

The kernels have no backward yet.  A CUDA call whose inputs require grad
(with grad mode on) raises ``NotImplementedError`` rather than return an
output with no gradient path: mamba2 and Jamba train on the card once the
scan has a VJP (ROADMAP Queue 1, item 9b).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels.ref import ssd_scan_ref

__all__ = ["ssd_scan", "ssd_mixer", "select_variant", "wgmma_operands", "LIBRARY", "CHUNK"]

MAX_STATE = 128
CHUNK = {"wgmma": 64, "cuda_core": 32}  # each variant's chunk length
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("ssd_scan", {
    # x, dt, A, B, C, y, h_out, states, decay, batch, S, H, G, P, N, strides, stream
    "wgmma": ("ssd_scan_wgmma_fwd",
              [_P] * 9 + [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong), _P]),
    # x, dt, A, B, C, y, h_out, BH, S, P, N, dtype, stream
    "cuda_core": ("ssd_scan_fwd", [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
})


def _no_grad_path(name: str, tensors) -> None:
    """Raise if a CUDA call would need a gradient the kernels cannot give."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA SSD scan has no VJP yet, so it cannot train on the card "
            "(ROADMAP Queue 1, item 9b); train on the CPU, or call it under torch.no_grad()")


def select_variant(P: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with head dim ``P``, state width ``N`` and
    ``dtype`` launches."""
    if dtype == torch.bfloat16 and P == 64 and N % 16 == 0 and 16 <= N <= MAX_STATE:
        return "wgmma"
    return "cuda_core"


def _tma_strides(t: torch.Tensor) -> list:
    """Element strides of a 4-D tensor as its TMA map takes them: a dim of
    size 1 gets the packed stride over the dims inside it (it is never
    stepped, and the map's strides then stay ordered)."""
    st = list(t.stride())
    for i in (2, 1, 0):
        if t.shape[i] == 1:
            st[i] = st[i + 1] * t.shape[i + 1]
    return st


def _tma_ready(t: torch.Tensor) -> bool:
    """TMA reads a tensor in place if its last dim is contiguous, it starts
    on 16 bytes and its other strides are multiples of 16 bytes."""
    st = _tma_strides(t)
    return st[3] == 1 and t.data_ptr() % 16 == 0 and all(s * t.element_size() % 16 == 0
                                                         for s in st[:3])


def wgmma_operands(x, dt, A2, Bm, Cm):
    """The operands the ``wgmma`` entry point reads, as views of the ones
    given wherever TMA can read those in place (a copy otherwise), and their
    element strides in the entry point's order (y's, which it allocates
    contiguous, last).  ``A2`` is A as ``[B, H]``."""
    x, Bm, Cm = (t if _tma_ready(t) else t.contiguous() for t in (x, Bm, Cm))
    if _tma_strides(Bm) != _tma_strides(Cm):
        Bm, Cm = Bm.contiguous(), Cm.contiguous()
    Bsz, S, H, P = x.shape
    y_strides = [S * H * P, H * P, P]
    strides = [*_tma_strides(x)[:3], *dt.stride(), *A2.stride(), *_tma_strides(Bm)[:3],
               *y_strides]
    return x, dt, A2, Bm, Cm, strides


def _launch_wgmma(x, dt, A2, Bm, Cm, return_state):
    """x [B, S, H, P] (bf16), dt [B, S, H] and A2 [B, H] (f32), Bm and Cm
    [B, S, G, N] (bf16), all on one card: y [B, S, H, P] and the final state
    [B, H, P, N] (f32) or None."""
    check_cuda_operands("ssd_scan", (x, Bm, Cm), (torch.bfloat16,), contiguous=False)
    check_cuda_operands("ssd_scan", (dt, A2), (torch.float32,), contiguous=False)
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: operands on {x.device} and {dt.device}")
    x, dt, A2, Bm, Cm, strides = wgmma_operands(x, dt, A2, Bm, Cm)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    nch = -(-S // CHUNK["wgmma"])
    dev = x.device
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev) if return_state else None
    # the kernel keeps each chunk's [P, N] state padded to 64 or 128 columns
    states = torch.empty((Bsz * H, nch, P * (64 if N <= 64 else 128)), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((Bsz * H, nch), dtype=torch.float32, device=dev)
    LIBRARY.launch("wgmma", x.data_ptr(), dt.data_ptr(), A2.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                   states.data_ptr(), decay.data_ptr(), Bsz, S, H, G, P, N,
                   (ctypes.c_longlong * len(strides))(*strides), stream_handle(x))
    return y, h


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
    _no_grad_path("ssd_scan", (x, dt, A, B, C))
    dtype = check_cuda_operands("ssd_scan", (x, B, C), (torch.float32, torch.bfloat16))
    check_cuda_operands("ssd_scan", (dt, A), (torch.float32,))
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: operands on {x.device} and {dt.device}")
    if select_variant(P, N, x.dtype) == "wgmma":
        # each sequence as a batch row of one head and one group
        y, h = _launch_wgmma(x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None],
                             C[:, :, None], return_state)
        return (y[:, :, 0], h[:, 0]) if return_state else y[:, :, 0]
    if N > MAX_STATE or N % 4:
        raise ValueError(f"ssd_scan: state width {N} is not a multiple of 4 up to {MAX_STATE}")
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device) if return_state else None
    LIBRARY.launch("cuda_core", x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                   C.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                   BH, S, P, N, dtype, stream_handle(x))
    return (y, h) if return_state else y


def ssd_mixer(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]  (post-softplus)
    A: torch.Tensor,   # [H]        (negative)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    return_state: bool = False,
):
    """The scan on the SSM mixer's layout (port of ``repro/kernels/ops.py``'s
    ``ssd_mixer``), head h reading group h // (H/G).  Returns y
    [B, S, H, P] in x's dtype; with ``return_state`` also the final state
    [B, H, P, N] in f32, which the reference's ``ssm_block`` takes from
    ``_ssd_chunked``.  The ``wgmma`` variant reads the tensors as they are
    (the views ``models/ssm.py`` slices from its conv output included); the
    plain version and the ``cuda_core`` variant take flat ``[B·H, S, *]``
    copies with the groups broadcast to heads.  Unlike the reference it does
    not pad S to its block: the kernels mask a ragged end themselves."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape != (Bsz, S, G, N)
            or Cm.shape != Bm.shape or H % G):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if x.device.type == "cuda":
        _no_grad_path("ssd_mixer", (x, dt, A, Bm, Cm))
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    if x.device.type == "cuda" and select_variant(P, N, x.dtype) == "wgmma":
        y, h = _launch_wgmma(x, dt, A[None].expand(Bsz, H), Bm, Cm, return_state)
        return (y, h) if return_state else y
    rep = H // G
    if rep != 1:
        Bm = Bm.repeat_interleave(rep, dim=2)
        Cm = Cm.repeat_interleave(rep, dim=2)
    xf = x.movedim(2, 1).reshape(Bsz * H, S, P).contiguous()
    dtf = dt.movedim(2, 1).reshape(Bsz * H, S).contiguous()
    Bf = Bm.movedim(2, 1).reshape(Bsz * H, S, N).contiguous()
    Cf = Cm.movedim(2, 1).reshape(Bsz * H, S, N).contiguous()
    out = ssd_scan(xf, dtf, A.repeat(Bsz), Bf, Cf, return_state=return_state)
    y = (out[0] if return_state else out).reshape(Bsz, H, S, P).movedim(1, 2)
    return (y, out[1].reshape(Bsz, H, P, N)) if return_state else y
