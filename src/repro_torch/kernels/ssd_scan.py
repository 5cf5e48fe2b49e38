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
- ``cuda_core``: f32, and every other shape, on flat contiguous ``[BH, S,
  *]`` operands.  The same three chunk-parallel phases over chunks of 64 on
  the CUDA cores in IEEE f32 (one launch of the variant): chunk_state (each
  chunk's own state term, transposed, and its decay, into a scratch whose
  size the CUDA source gives), the state pass, and chunk_scan (C Bᵀ, the
  masked scores and their product with x before the state pass is waited
  for, then C hᵀ).  Two tile classes by the state width
  (``CUDA_CORE_CLASSES``) and two load paths, which :func:`cuda_core_plan`
  repeats from the C side's choice and :func:`cuda_core_plan_of_code` reads
  from its code; :func:`cuda_core_waves` counts the phases' CTAs and waves.

Both mask a ragged end themselves, so they take any ``S``: the reference's
``S % block_s == 0`` is a property of the TPU grid, and nothing pads for it.
Unlike the Pallas kernel they can also return the final state (f32), which a
prefill needs for its cache.  CPU tensors take the plain version,
:func:`ref.ssd_scan_ref`, and autograd runs through it; CUDA tensors launch
the selected variant or raise.  ``meta`` tensors take the CUDA route
without launching: :class:`_SSDScan` returns empty outputs and counts the
launch the selected variant would make.  Every call of :func:`ssd_scan` or
:func:`ssd_mixer` records its :func:`work` once, at the entry
(``kernels/_work.py``), whichever of the three routes it takes.

On the card each launch sits in :class:`_SSDScan`, an
``autograd.Function``.  The Pallas kernel has no VJP of its own (the
reference trains through ``_ssd_chunked``, which XLA differentiates), so
the backward computes what ``jax.vjp`` of ``_ssd_chunked`` gives;
:func:`select_bwd_variant` picks how:

- ``wgmma_bwd`` behind the ``wgmma`` forward: a backward kernel in the same
  source (three kernels, one launch of the variant: the chunk-start states
  and the state cotangents carried over the chunks in registers and written
  once as bf16 hi + lo tiles; every gradient of a chunk of a group's heads
  on the tensor cores, in clusters of CTAs that sum dB and dC over the heads
  on chip in a fixed order; dA over chunks; no float atomics).  It records
  :func:`work_bwd`; a failed build or launch raises, nothing tries the VJP
  instead.
- ``"vjp"`` behind ``cuda_core`` (f32, other shapes): :func:`ssd_scan_vjp`,
  the chunked form's VJP in PyTorch, recorded as ``("ssd_scan", "vjp")``.
  It is also the plain version the backward kernel is held against.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import KernelLibrary, check_cuda_operands, stream_handle
from repro_torch.kernels._work import record, uncounted
from repro_torch.kernels.ref import on_flat_heads, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_mixer", "ssd_scan_vjp", "select_variant", "select_bwd_variant",
           "wgmma_operands", "cuda_core_plan", "cuda_core_plan_of_code",
           "cuda_core_scratch_floats", "cuda_core_waves",
           "work", "work_bwd", "LIBRARY", "CHUNK", "VJP_CHUNK", "CUDA_CORE_CLASSES"]

MAX_STATE = 128
CHUNK = {"wgmma": 64, "cuda_core": 64}  # each variant's chunk length
# The CUDA-core kernels' tile classes (csrc/ssd_scan.cu, namespace simt), in
# the order of their C index, as its C function ssd_cuda_core_layout gives
# them (a card test holds the two equal): the state width the tiles hold
# (zero past N), the chunk length, the columns of P a CTA takes (the grid's z
# axis walks P), chunk_scan's threads (chunk_state's are 128), phase 1's
# (chunk_state) and phase 3's (chunk_scan) dynamic shared memory in bytes,
# and the CTAs an SM the card gives each phase's f32 kernel (its registers
# and shared memory; at least the count its launch bounds name).  The class
# is the smallest whose np holds N.
CUDA_CORE_CLASSES = {
    "n32": dict(np=32, chunk=64, p_tile=64, scan_threads=256, state_smem=25088, scan_smem=43520,
                state_ctas=7, scan_ctas=3),
    "n128": dict(np=128, chunk=64, p_tile=64, scan_threads=256, state_smem=49664, scan_smem=84480,
                 state_ctas=4, scan_ctas=2),
}
VJP_CHUNK = 64  # the backward's chunk length (any length gives the same gradients)
# the backward works on slices of (batch, group, head in group) whose
# [..., chunk, chunk] intermediates hold at most this many elements (64 MB in f32)
VJP_CHUNK_ELEMS = 1 << 24
_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = KernelLibrary("ssd_scan", {
    # x, dt, A, B, C, y, h_out, states, decay, batch, S, H, G, P, N, strides, stream
    "wgmma": ("ssd_scan_wgmma_fwd",
              [_P] * 9 + [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong), _P]),
    # x, dt, A, B, C, y, h_out, scratch, BH, S, P, N, dtype, stream
    "cuda_core": ("ssd_scan_fwd", [_P] * 8 + [_I] * 5 + [_P]),
    # x, dt, A, B, C, dy, dh_final, dx, ddt, dA, dB, dC, h0s, dh1s, part_a,
    # batch, S, H, G, P, N, strides, stream
    "wgmma_bwd": ("ssd_scan_wgmma_bwd",
                  [_P] * 15 + [_I] * 6 + [ctypes.POINTER(ctypes.c_longlong), _P]),
})


def select_variant(P: int, N: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA call with head dim ``P``, state width ``N`` and
    ``dtype`` launches."""
    if dtype == torch.bfloat16 and P == 64 and N % 16 == 0 and 16 <= N <= MAX_STATE:
        return "wgmma"
    return "cuda_core"


def cuda_core_plan(P: int, N: int, dtype: torch.dtype, aligned: bool = True) -> tuple:
    """(tile class, load path) of a ``cuda_core`` call with head dim P and
    state width N, as the C side (``ssd_cuda_core_plan``) picks them before
    the launch.  ``aligned``: x, B, C and y start on 16-byte boundaries.  The
    class: the smallest of ``CUDA_CORE_CLASSES`` whose state width holds N.
    The path: ``fast`` for f32 with P a multiple of 4 and aligned operands
    (x, B, C and the states come 16 bytes at a time by ``cp.async``, y goes
    out 16 bytes at a time), else ``general`` (element loads converted to
    f32; the states still by 16 bytes)."""
    if P <= 0 or N <= 0 or N > MAX_STATE or N % 4 or dtype not in (torch.float32,
                                                                    torch.bfloat16):
        raise ValueError(f"no CUDA-core plan for P={P} N={N} {dtype}")
    cls = next(name for name, c in CUDA_CORE_CLASSES.items() if N <= c["np"])
    path = "fast" if dtype == torch.float32 and P % 4 == 0 and aligned else "general"
    return cls, path


def cuda_core_plan_of_code(code: int) -> tuple:
    """(tile class, load path) from the C side's plan code
    (``ssd_cuda_core_plan``): the class's index in ``CUDA_CORE_CLASSES``
    times 2, plus 1 on the fast path."""
    if not 0 <= code < 2 * len(CUDA_CORE_CLASSES):
        raise ValueError(f"no CUDA-core plan has code {code}")
    return list(CUDA_CORE_CLASSES)[code // 2], ("general", "fast")[code % 2]


def cuda_core_scratch_floats(BH: int, S: int, P: int, N: int) -> int:
    """f32 elements of a ``cuda_core`` call's scratch, as the C side
    (``ssd_cuda_core_scratch_floats``, which the wrapper allocates from)
    counts them: each chunk's state [N, P padded to a multiple of 4], then
    each chunk's decay."""
    nch = -(-S // CHUNK["cuda_core"])
    return BH * nch * N * (-(-P // 4) * 4) + BH * nch


def cuda_core_waves(BH: int, S: int, P: int, N: int, sms: int = 132) -> dict:
    """(CTAs, waves) of a ``cuda_core`` call's two product phases: one CTA
    a (sequence, chunk, 64 columns of P), ``state_ctas`` / ``scan_ctas`` of
    them an SM (the class's shared memory and launch bounds; the card's
    occupancy count confirms it), so ceil(CTAs / (SMs · CTAs an SM))
    waves each.  The state pass between them has a CTA per 1,024 elements
    of a state and sequence."""
    c = CUDA_CORE_CLASSES[cuda_core_plan(P, N, torch.float32)[0]]
    ctas = BH * -(-S // c["chunk"]) * -(-P // c["p_tile"])
    return {phase: (ctas, -(-ctas // (sms * c[f"{phase}_ctas"]))) for phase in ("state", "scan")}


def select_bwd_variant(P: int, N: int, dtype: torch.dtype) -> str:
    """The backward behind a CUDA call of these shapes and dtype:
    ``"wgmma_bwd"`` (a kernel launch) behind the ``wgmma`` forward,
    otherwise ``"vjp"`` (:func:`ssd_scan_vjp`)."""
    return "wgmma_bwd" if select_variant(P, N, dtype) == "wgmma" else "vjp"


def work(heads: int, groups: int, S: int, P: int, N: int, elem: int, chunk: int) -> tuple:
    """(operations, bytes) of one scan over ``heads`` sequences that read
    ``groups`` B and C sequences (a flat ``[BH, S, *]`` call: groups =
    heads; the mixer's layout: the model's groups).  Operations: the chunked
    form at the variant's ``chunk``, per head and chunk C·Bᵀ and
    (C·Bᵀ∘L)·x over the lower triangle, C·h and the state update in full;
    2 per multiply-add.  Bytes: x read and y written, B and C read, in the
    input type (``elem`` bytes); dt, A read and the final state written in
    f32."""
    nbytes = ((2 * heads * S * P + 2 * groups * S * N) * elem + heads * S * 4 + heads * 4
              + heads * P * N * 4)
    Q = chunk
    macs = -(-S // Q) * (Q * (Q + 1) // 2 * (N + P) + 2 * Q * P * N)
    return 2.0 * heads * macs, nbytes


def work_bwd(heads: int, groups: int, S: int, P: int, N: int, elem: int,
             chunk: int = VJP_CHUNK) -> tuple:
    """(operations, bytes) of one backward over ``heads`` sequences that
    read ``groups`` B and C sequences.  Operations: the chunked form's
    products at ``chunk``, per head and chunk 6 of Q·P·N (the chunk's state
    and its cotangent's term, h0 Cᵀ, dh1 Bᵀ, dy h0, x dh1) and 2 of Q·Q·P
    (dy xᵀ, Kᵀ dy), per group and chunk 3 of Q·Q·N (C Bᵀ, dCB B, dCBᵀ C);
    2 per multiply-add.  Bytes: x and dy read and dx written, B and C read
    and dB and dC written, in the input type (``elem`` bytes); dt read and
    ddt written, A read and dA written, in f32."""
    Q, nc = chunk, -(-S // chunk)
    nbytes = (3 * heads * S * P + 4 * groups * S * N) * elem + 2 * heads * S * 4 + 2 * heads * 4
    ops = 2.0 * nc * (heads * (6 * Q * P * N + 2 * Q * Q * P) + groups * 3 * Q * Q * N)
    return ops, nbytes


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
    if x.is_meta:
        LIBRARY.account("wgmma")
        return y, h
    # the kernel keeps each chunk's [P, N] state padded to 64 or 128 columns
    states = torch.empty((Bsz * H, nch, P * (64 if N <= 64 else 128)), dtype=torch.float32,
                         device=dev)
    decay = torch.empty((Bsz * H, nch), dtype=torch.float32, device=dev)
    LIBRARY.launch("wgmma", x.data_ptr(), dt.data_ptr(), A2.data_ptr(), Bm.data_ptr(),
                   Cm.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                   states.data_ptr(), decay.data_ptr(), Bsz, S, H, G, P, N,
                   (ctypes.c_longlong * len(strides))(*strides), stream_handle(x))
    return y, h


def _launch_bwd(x, dt, A2, Bm, Cm, dy, dh_final):
    """Launch ``wgmma_bwd`` on the forward's operands (x [B, S, H, P], dt
    [B, S, H], A2 [B, H], Bm and Cm [B, S, G, N], as :func:`_launch_wgmma`
    takes them) at the cotangents dy [B, S, H, P] (bf16) and dh_final
    [B, H, P, N] (f32, or None for zero): (dx, ddt, dA2, dB, dC) in the
    operands' dtypes and shapes."""
    check_cuda_operands("ssd_scan", (x, Bm, Cm, dy), (torch.bfloat16,), contiguous=False)
    check_cuda_operands("ssd_scan", (dt, A2), (torch.float32,), contiguous=False)
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: operands on {x.device} and {dt.device}")
    x, dt, A2, Bm, Cm, strides = wgmma_operands(x, dt, A2, Bm, Cm)
    dy = dy if _tma_ready(dy) else dy.contiguous()
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev, f32 = x.device, torch.float32
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((Bsz, H), dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=Bm.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=Cm.dtype, device=dev)
    if x.is_meta:
        LIBRARY.account("wgmma_bwd")
        return dx, ddt, dA, dB, dC
    if dh_final is not None:
        dh_final = dh_final.to(f32).contiguous()
    h0s, dh1s, part_a = bwd_scratch(Bsz, S, H, P, N, dev)
    strides = strides[:11] + _tma_strides(dy)[:3]
    LIBRARY.launch("wgmma_bwd", *(t.data_ptr() if t is not None else None for t in (
        x, dt, A2, Bm, Cm, dy, dh_final, dx, ddt, dA, dB, dC, h0s, dh1s, part_a)),
        Bsz, S, H, G, P, N, (ctypes.c_longlong * 14)(*strides), stream_handle(x))
    return dx, ddt, dA, dB, dC


def bwd_scratch(Bsz: int, S: int, H: int, P: int, N: int, device) -> tuple:
    """The scratch of one ``wgmma_bwd`` launch: the states the chunks start
    from (h0s) and the cotangents of the states they end with (dh1s), each
    [B·H, chunks, 2·P·64] bf16 (2·P·128 for N > 64: a state's bf16 hi and lo
    halves, in the tiles the gradient phase reads, as many bytes as the f32
    state), and each (head, chunk)'s share of dA ([B·H, chunks] f32).  dB and
    dC are summed over the heads of a group on chip: nothing per head."""
    nch = -(-S // CHUNK["wgmma"])
    h0s, dh1s = (torch.empty((Bsz * H, nch, 2 * P * (64 if N <= 64 else 128)),
                             dtype=torch.bfloat16, device=device) for _ in range(2))
    return h0s, dh1s, torch.empty((Bsz * H, nch), dtype=torch.float32, device=device)


def _launch_cuda_core(x, dt, A2, Bm, Cm, return_state):
    """The ``cuda_core`` variant on one-head operands in the mixer's layout
    (x [BH, S, 1, P], dt [BH, S, 1], A2 [BH, 1], Bm and Cm [BH, S, 1, N]:
    views of flat contiguous ``[BH, S, *]`` tensors): y [BH, S, 1, P] and
    the final state [BH, 1, P, N] (f32) or None."""
    x, dt, A, Bm, Cm = x[:, :, 0], dt[:, :, 0], A2[:, 0], Bm[:, :, 0], Cm[:, :, 0]
    BH, S, P = x.shape
    N = Bm.shape[-1]
    dtype = check_cuda_operands("ssd_scan", (x, Bm, Cm), (torch.float32, torch.bfloat16))
    check_cuda_operands("ssd_scan", (dt, A), (torch.float32,))
    if dt.device != x.device:
        raise ValueError(f"ssd_scan: operands on {x.device} and {dt.device}")
    if N > MAX_STATE or N % 4:
        raise ValueError(f"ssd_scan: state width {N} is not a multiple of 4 up to {MAX_STATE}")
    y = torch.empty_like(x)
    h = torch.empty((BH, P, N), dtype=torch.float32, device=x.device) if return_state else None
    if x.is_meta:
        LIBRARY.account("cuda_core")
    else:
        scratch = torch.empty(LIBRARY.size("ssd_cuda_core_scratch_floats", BH, S, P, N),
                              dtype=torch.float32, device=x.device)
        LIBRARY.launch("cuda_core", x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                       Cm.data_ptr(), y.data_ptr(), h.data_ptr() if return_state else None,
                       scratch.data_ptr(), BH, S, P, N, dtype, stream_handle(x))
    return y[:, :, None], (h[:, None] if return_state else None)


def _chunk_starts(decay: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The state each chunk starts from: h_0 = 0, h_{c+1} = decay_c h_c + s_c
    (``decay`` [b, nc, ...], ``s`` [b, nc, ..., P, N])."""
    h = torch.zeros_like(s[:, 0])
    out = torch.empty_like(s)
    for c in range(s.shape[1]):
        out[:, c] = h
        h = decay[:, c, ..., None, None] * h + s[:, c]
    return out


def _chunk_end_grads(decay: torch.Tensor, r: torch.Tensor,
                     dh_final: Optional[torch.Tensor]) -> torch.Tensor:
    """The cotangent of the state each chunk ends with, carried backwards:
    dh_end(last) = ``dh_final`` (or 0), dh_end(c - 1) = decay_c dh_end(c) + r_c,
    where r_c = Σ_i exp(cs_i) dy_i C_iᵀ is chunk c's own term."""
    dh = torch.zeros_like(r[:, 0]) if dh_final is None else dh_final
    out = torch.empty_like(r)
    for c in reversed(range(r.shape[1])):
        out[:, c] = dh
        dh = decay[:, c, ..., None, None] * dh + r[:, c]
    return out


def _inter_chunk_dcs(ecs: torch.Tensor, dy: torch.Tensor, h0C: torch.Tensor) -> torch.Tensor:
    """d cs_i of the inter-chunk term exp(cs_i) h_0 C_i: exp(cs_i) dy_i · (h_0 C_i)."""
    return ecs * (dy * h0C).sum(-1)


def _vjp_slice(x, dt, A, B, C, dy, dh_final, Q: int):
    """:func:`ssd_scan_vjp` on one slice, every operand in the accumulation
    dtype: x, dy [b, S, g, r, P], dt [b, S, g, r], A [b, g, r], B, C
    [b, S, g, N], dh_final [b, g, r, P, N] or None.  Returns dx, ddt, dA, dB,
    dC in those shapes (dB, dC summed over the slice's heads r)."""
    b, S = x.shape[:2]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t, lead: int):
        """[b, S, ...] -> [b, nc, <the next ``lead`` dims>, Q, <the rest>],
        zero past S (dt = 0 there: no decay, no input, no gradient)."""
        t = F.pad(t, [0, 0] * (t.ndim - 2) + [0, pad]).reshape(b, nc, Q, *t.shape[2:])
        return t.movedim(2, 2 + lead)

    xc, dyc = chunks(x, 2), chunks(dy, 2)              # [b, nc, g, r, Q, P]
    dtc = chunks(dt, 2)                                # [b, nc, g, r, Q]
    Bc, Cc = chunks(B, 1), chunks(C, 1)                # [b, nc, g, Q, N]
    Ab = A[:, None, :, :, None]
    cs = torch.cumsum(dtc * Ab, dim=-1)                # cs_i, along the innermost dim
    T = cs[..., -1]                                    # [b, nc, g, r]
    decay = torch.exp(T)
    ecs = torch.exp(cs)                                # exp(cs_i)
    w = torch.exp(T[..., None] - cs)                   # exp(T - cs_j)
    u = xc * dtc[..., None]                            # u_j = dt_j x_j
    uw = u * w[..., None]
    # forward over chunks: the states the chunks start from (recomputed)
    h0 = _chunk_starts(decay, torch.einsum("bcgrjp,bcgjn->bcgrpn", uw, Bc))
    # backward over chunks: the cotangents of the states they end with
    dyecs = dyc * ecs[..., None]
    dh1 = _chunk_end_grads(decay, torch.einsum("bcgrip,bcgin->bcgrpn", dyecs, Cc), dh_final)

    # within each chunk; L_ij = exp(cs_i - cs_j) for j <= i
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~causal, float("-inf")))
    CB = torch.einsum("bcgin,bcgjn->bcgij", Cc, Bc)
    K = CB[:, :, :, None] * L                          # y_i = Σ_j K_ij u_j + ...
    dhB = torch.einsum("bcgrpn,bcgjn->bcgrjp", dh1, Bc)
    du = torch.einsum("bcgrij,bcgrip->bcgrjp", K, dyc) + w[..., None] * dhB
    Gm = torch.einsum("bcgrip,bcgrjp->bcgrij", dyc, u)  # dy_i · u_j
    M = K * Gm                                         # d cs through L
    dCB = (L * Gm).sum(3)
    del L, K, Gm
    dC = (torch.einsum("bcgij,bcgjn->bcgin", dCB, Bc)
          + torch.einsum("bcgrip,bcgrpn->bcgin", dyecs, h0))
    dB = (torch.einsum("bcgij,bcgin->bcgjn", dCB, Cc)
          + torch.einsum("bcgrjp,bcgrpn->bcgjn", uw, dh1))
    del dCB
    W = w * (u * dhB).sum(-1)                          # d(T - cs_j) through the end state
    h0C = torch.einsum("bcgrpn,bcgin->bcgrip", h0, Cc)
    dcs = M.sum(-1) - M.sum(-2) + _inter_chunk_dcs(ecs, dyc, h0C) - W
    del M
    dcs[..., -1] += W.sum(-1) + decay * (dh1 * h0).sum((-1, -2))  # d T
    da = dcs.flip(-1).cumsum(-1).flip(-1)              # a_t enters every cs_i, i >= t
    dA = (dtc * da).sum((1, -1))

    def unchunks(t, lead: int):
        t = t.movedim(2 + lead, 2)
        return t.reshape(b, nc * Q, *t.shape[3:])[:, :S]

    return (unchunks(dtc[..., None] * du, 2),
            unchunks((xc * du).sum(-1) + Ab * da, 2), dA,
            unchunks(dB, 1), unchunks(dC, 1))


def ssd_scan_vjp(
    x: torch.Tensor,    # [B, S, H, P]
    dt: torch.Tensor,   # [B, S, H]
    A: torch.Tensor,    # [B, H]
    B: torch.Tensor,    # [B, S, G, N]
    C: torch.Tensor,    # [B, S, G, N]
    dy: Optional[torch.Tensor],        # [B, S, H, P]
    dh_final: Optional[torch.Tensor],  # [B, H, P, N]
    chunk: int = VJP_CHUNK,
):
    """(dx, ddt, dA, dB, dC) of the scan on the mixer's layout (head h
    reading group h // (H/G)) at the cotangents ``dy`` of y and ``dh_final``
    of the final state (``None`` for zero), in the inputs' dtypes and
    shapes.  Computed in f32 (f64 for f64 inputs) over chunks of ``chunk``
    positions.  For one chunk, with a_t = dt_t A, cs = cumsum(a), T = cs_last,
    L_ij = exp(cs_i - cs_j) for j <= i, u_j = dt_j x_j and h_0 the state the
    chunk starts from:

        y_i = Σ_{j<=i} (C_i·B_j) L_ij u_j + exp(cs_i) h_0 C_i,
        h_1 = exp(T) h_0 + Σ_j exp(T - cs_j) u_j B_jᵀ;

    a forward pass over chunks recomputes every h_0, and a backward pass
    carries dh_0 = exp(T) dh_1 + Σ_i exp(cs_i) dy_i C_iᵀ from the last chunk
    (where dh_1 = ``dh_final``) to the first.  Within a chunk:

        du_j = Σ_{i>=j} (C_i·B_j) L_ij dy_i + exp(T - cs_j) dh_1 B_j;
        dC_i, dB_j from the masked scores C_i·B_j and from both state terms
        (summed over the heads of a group);
        dcs from L, from exp(cs_i) in the inter-chunk term, and from
        exp(T - cs_j) and exp(T) in h_1; da = reverse cumsum of dcs;
        dx_j = dt_j du_j, ddt_j = x_j·du_j + A da_j, dA = Σ_t dt_t da_t.

    Positions past S are zero (dt = 0 there) and get no gradient.  The
    work goes in slices of (batch row, group, head within the group) whose
    ``[..., chunk, chunk]`` intermediates hold at most ``VJP_CHUNK_ELEMS``
    elements each."""
    Bsz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R = H // G
    acc = torch.promote_types(x.dtype, torch.float32)
    if dy is None:
        dy = torch.zeros_like(x)
    dx = torch.empty((Bsz, S, G, R, P), dtype=x.dtype, device=x.device)
    ddt = torch.empty((Bsz, S, G, R), dtype=dt.dtype, device=x.device)
    dA = torch.empty((Bsz, G, R), dtype=A.dtype, device=x.device)
    dB = torch.zeros((Bsz, S, G, N), dtype=acc, device=x.device)
    dC = torch.zeros((Bsz, S, G, N), dtype=acc, device=x.device)
    units = max(1, VJP_CHUNK_ELEMS // (-(-S // chunk) * chunk * chunk))
    r_step = min(R, units)
    g_step = min(G, max(1, units // r_step))
    b_step = max(1, units // (r_step * g_step))
    x5, dy5 = x.reshape(Bsz, S, G, R, P), dy.reshape(Bsz, S, G, R, P)
    dt4, A3 = dt.reshape(Bsz, S, G, R), A.reshape(Bsz, G, R)
    dh5 = None if dh_final is None else dh_final.reshape(Bsz, G, R, P, N)
    for b0 in range(0, Bsz, b_step):
        for g0 in range(0, G, g_step):
            for r0 in range(0, R, r_step):
                bs, gs, rs = slice(b0, b0 + b_step), slice(g0, g0 + g_step), slice(r0, r0 + r_step)
                out = _vjp_slice(
                    x5[bs, :, gs, rs].to(acc), dt4[bs, :, gs, rs].to(acc), A3[bs, gs, rs].to(acc),
                    B[bs, :, gs].to(acc), C[bs, :, gs].to(acc), dy5[bs, :, gs, rs].to(acc),
                    None if dh5 is None else dh5[bs, gs, rs].to(acc), chunk)
                dx[bs, :, gs, rs] = out[0]
                ddt[bs, :, gs, rs] = out[1]
                dA[bs, gs, rs] = out[2]
                dB[bs, :, gs] += out[3]
                dC[bs, :, gs] += out[4]
    return (dx.reshape(x.shape), ddt.reshape(dt.shape), dA.reshape(A.shape),
            dB.to(B.dtype), dC.to(C.dtype))


class _SSDScan(torch.autograd.Function):
    """Either variant's launch forward (``_launch_wgmma`` on the mixer's
    layout, ``_launch_cuda_core`` on one-head views of flat operands);
    backward the ``wgmma_bwd`` launch behind ``wgmma`` where
    :func:`select_bwd_variant` picks it, :func:`ssd_scan_vjp` otherwise.
    Unused cotangents stay ``None``: a train step discards the final state,
    and no zeros are made for it."""

    @staticmethod
    def forward(ctx, x, dt, A2, Bm, Cm, variant: str, return_state: bool):
        launch = _launch_wgmma if variant == "wgmma" else _launch_cuda_core
        y, h = launch(x, dt, A2, Bm, Cm, return_state)
        ctx.save_for_backward(x, dt, A2, Bm, Cm)
        ctx.set_materialize_grads(False)
        ctx.bwd = (select_bwd_variant(x.shape[-1], Bm.shape[-1], x.dtype) if variant == "wgmma"
                   else "vjp")
        return (y, h) if return_state else y

    @staticmethod
    def backward(ctx, dy, dh=None):
        x, dt, A2, Bm, Cm = ctx.saved_tensors
        if ctx.bwd == "vjp":
            with uncounted("ssd_scan"):
                grads = ssd_scan_vjp(x, dt, A2, Bm, Cm, dy, dh)
        else:
            Bsz, S, H, P = x.shape
            G, N = Bm.shape[2], Bm.shape[3]
            record("ssd_scan", ctx.bwd, work_bwd(Bsz * H, Bsz * G, S, P, N, x.element_size()))
            grads = _launch_bwd(x, dt, A2, Bm, Cm, torch.zeros_like(x) if dy is None else dy, dh)
        return (*grads, None, None)


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
    variant = select_variant(P, N, x.dtype)
    record("ssd_scan", variant, work(BH, BH, S, P, N, x.element_size(), CHUNK[variant]))
    return _scan(x, dt, A, B, C, return_state)


def _scan(x, dt, A, B, C, return_state: bool = False):
    """:func:`ssd_scan` without recording its work (the mixer records its
    own call)."""
    if x.device.type == "cpu":
        with uncounted():
            return ssd_scan_ref(x, dt, A, B, C, return_state=return_state)
    P, N = x.shape[-1], B.shape[-1]
    # each sequence as a batch row of one head and one group
    out = _SSDScan.apply(x[:, :, None], dt[:, :, None], A[:, None], B[:, :, None],
                         C[:, :, None], select_variant(P, N, x.dtype), return_state)
    return (out[0][:, :, 0], out[1][:, 0]) if return_state else out[:, :, 0]


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
    (the views ``models/ssm.py`` slices from its conv output included, whose
    gradients reach the conv output through autograd's view handling); the
    plain version and the ``cuda_core`` variant take flat ``[B·H, S, *]``
    copies with the groups broadcast to heads (``ref.on_flat_heads``).
    Unlike the reference it does not pad S to its block: the kernels mask a
    ragged end themselves."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or Bm.shape != (Bsz, S, G, N)
            or Cm.shape != Bm.shape or H % G):
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"B {tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    dt, A = dt.to(torch.float32), A.to(torch.float32)
    variant = select_variant(P, N, x.dtype)
    wgmma = variant == "wgmma"
    record("ssd_scan", variant, work(Bsz * H, Bsz * (G if wgmma else H), S, P, N,
                                     x.element_size(), CHUNK[variant]))
    if x.device.type != "cpu" and wgmma:
        # A's gradient comes back [B, H] and autograd sums it over the expand
        return _SSDScan.apply(x, dt, A[None].expand(Bsz, H), Bm, Cm, "wgmma", return_state)
    return on_flat_heads(_scan, x, dt, A, Bm, Cm, return_state)
