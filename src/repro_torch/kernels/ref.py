"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``: the same functions with f32 accumulation.
The kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card; :func:`flash_attention_bwd_ref`
and :func:`swiglu_bwd_ref` are the backward kernels'; the ``"vjp"``
backward routes (f32, and shapes the kernels do not take) compute through
the former and share :func:`swiglu_derivative` with the latter.  Beside them,
:func:`ssd_scan_three_phase` emulates the ``wgmma`` SSD-scan kernel's
decomposition and operand rounding on the CPU, for the tests.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e30  # finite: a fully masked row stays finite, as in the reference


def flash_attention_ref(
    q: torch.Tensor,  # [BH, Sq, D]
    k: torch.Tensor,  # [BH, Sk, D]
    v: torch.Tensor,  # [BH, Sk, Dv]
    causal: bool = True,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """softmax(q kᵀ · scale) v in f32: [BH, Sq, Dv] in q's dtype; with
    ``return_lse`` also each row's logsumexp of its masked scaled scores
    (natural log, f32 [BH, Sq]), which the ``mma`` kernel writes for the
    backward."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqd,bkd->bqk", q.to(F32), k.to(F32)) * sc
    if causal:
        s = torch.where(causal_mask(q.shape[1], k.shape[1], q.device)[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", p, v.to(F32)).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o


def causal_mask(Sq: int, Sk: int, device) -> torch.Tensor:
    """[Sq, Sk]: query i sees key j iff j <= i + Sk - Sq."""
    kpos = torch.arange(Sk, device=device)
    qpos = torch.arange(Sq, device=device)
    return kpos[None, :] <= (qpos[:, None] + (Sk - Sq))


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal: bool = True,
                            scale: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention_ref` at the cotangent ``do``,
    from the forward's output ``o`` and its ``lse``, as the ``mma_bwd``
    kernel computes them, in f32 (f64 for f64 inputs), returned in the
    inputs' dtypes:

        P = exp(q kᵀ · scale - lse);  delta = rowsum(dO ⊙ O);
        dV = Pᵀ dO;  dS = P ⊙ (dO Vᵀ - delta);
        dQ = dS K · scale;  dK = dSᵀ Q · scale.

    A masked pair has dS = 0 (autograd through the forward's ``where``) and
    P = 0, but a row that sees no key (when causal and Sq > Sk) has the
    forward's uniform P = 1/Sk.  With ``lse`` None, P is the softmax of the
    masked scaled scores, computed here (the backward of a forward that
    writes no lse)."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, F32)
    qf, kf, vf, of, dof = (t.to(acc) for t in (q, k, v, o, do))
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * sc
    Sq, Sk = q.shape[1], k.shape[1]
    mask = causal_mask(Sq, Sk, q.device) if causal else None
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    if lse is None:
        p = torch.softmax(s, dim=-1)
    else:
        p = torch.exp(s - lse.to(acc)[..., None])
        if mask is not None:  # a row that sees no key: the forward's uniform P
            blind = (torch.arange(Sq, device=q.device) + (Sk - Sq) < 0)[:, None]
            p = torch.where(blind, 1.0 / Sk, p)
    del s
    ds = p * (torch.einsum("bqd,bkd->bqk", dof, vf) - (dof * of).sum(-1)[..., None])
    if mask is not None:
        ds = torch.where(mask, ds, 0.0)
    dq = torch.einsum("bqk,bkd->bqd", ds, kf) * sc
    dk = torch.einsum("bqk,bqd->bkd", ds, qf) * sc
    dv = torch.einsum("bqk,bqd->bkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ssd_scan_ref(
    x: torch.Tensor,   # [BH, S, P]
    dt: torch.Tensor,  # [BH, S]      (f32, post-softplus)
    A: torch.Tensor,   # [BH]         (f32, negative)
    B: torch.Tensor,   # [BH, S, N]
    C: torch.Tensor,   # [BH, S, N]
    return_state: bool = False,
):
    """Exact sequential SSD recurrence: h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t,
    y_t = C_t · h_t, in f32 (f64 for f64 inputs).  Returns y [BH, S, P] in
    x's dtype and, with ``return_state``, also the final state h [BH, P, N]
    in f32 (f64)."""
    BH, S, P = x.shape
    N = B.shape[-1]
    acc = torch.promote_types(x.dtype, F32)
    xf, Bf, Cf = x.to(acc), B.to(acc), C.to(acc)
    dtf, Af = dt.to(acc), A.to(acc)
    h = torch.zeros((BH, P, N), dtype=acc, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t] * Af)
        h = h * dA[:, None, None] + torch.einsum(
            "bp,bn,b->bpn", xf[:, t], Bf[:, t], dtf[:, t])
        ys.append(torch.einsum("bn,bpn->bp", Cf[:, t], h))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def on_flat_heads(scan, x, dt, A, Bm, Cm, return_state: bool = False):
    """``scan`` (over flat ``[B·H, S, *]`` operands, as :func:`ssd_scan_ref`
    takes them) on the mixer's layout: x [B, S, H, P], dt [B, S, H], A [H],
    Bm and Cm [B, S, G, N], head h reading group h // (H/G).  The operands
    are copied to the flat layout with the groups broadcast to heads; y
    comes back as [B, S, H, P] and the final state as [B, H, P, N]."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    rep = H // Bm.shape[2]
    if rep != 1:
        Bm = Bm.repeat_interleave(rep, dim=2)
        Cm = Cm.repeat_interleave(rep, dim=2)
    xf = x.movedim(2, 1).reshape(Bsz * H, S, P).contiguous()
    dtf = dt.movedim(2, 1).reshape(Bsz * H, S).contiguous()
    Bf = Bm.movedim(2, 1).reshape(Bsz * H, S, N).contiguous()
    Cf = Cm.movedim(2, 1).reshape(Bsz * H, S, N).contiguous()
    out = scan(xf, dtf, A.repeat(Bsz), Bf, Cf, return_state=return_state)
    y = (out[0] if return_state else out).reshape(Bsz, H, S, P).movedim(1, 2)
    return (y, out[1].reshape(Bsz, H, P, N)) if return_state else y


def ssd_mixer_ref(x, dt, A, Bm, Cm, return_state: bool = False):
    """:func:`ssd_scan_ref` on the mixer's layout (:func:`on_flat_heads`)."""
    return on_flat_heads(ssd_scan_ref, x, dt, A, Bm, Cm, return_state)


def _split_bf16(t: torch.Tensor):
    """f32 -> (hi, lo), each a bf16 value held in f32: hi = bf16(t),
    lo = bf16(t - hi)."""
    hi = t.to(torch.bfloat16).to(F32)
    return hi, (t - hi).to(torch.bfloat16).to(F32)


def ssd_scan_three_phase(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]     (f32)
    A: torch.Tensor,   # [H] or [B, H] (f32)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    return_state: bool = False,
    lo: bool = True,
):
    """The ``wgmma`` kernel's arithmetic on the CPU, for the tests (not a
    plain version: that is :func:`ssd_scan_ref`).  Its three phases over
    chunks of 64 positions, head h reading group h // (H/G):

    1. s_c = (x∘w)^T B with w_j = exp(cs_Q - cs_j) dt_j, and decay_c = exp(cs_Q);
    2. h_0 = 0, h_{c+1} = decay_c h_c + s_c;
    3. y = (C B^T ∘ L ∘ dt) x + exp(cs) ∘ (C h_c^T).

    Each f32 operand the kernel feeds to the bf16 tensor cores (x∘w, the
    masked scores, h_c) enters as hi + lo bf16 halves, two products summed in
    f32; ``lo=False`` drops the lo halves (a planted fault).  The inputs x, B
    and C enter as they are.  Returns y [B, S, H, P] in x's dtype and, with
    ``return_state``, the final state [B, H, P, N] in f32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = 64
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # [B, S, ...] -> [B, nc, Q, ...], zero past S
        t = F.pad(t.to(F32), [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    split = _split_bf16 if lo else (lambda t: (t.to(torch.bfloat16).to(F32), None))

    def mm(eq, a, b, split_a=False, split_b=False):
        """einsum in f32 with a or b entering as its hi + lo halves."""
        if split_a:
            hi, low = split(a)
            return torch.einsum(eq, hi, b) + (0 if low is None else torch.einsum(eq, low, b))
        if split_b:
            hi, low = split(b)
            return torch.einsum(eq, a, hi) + (0 if low is None else torch.einsum(eq, a, low))
        return torch.einsum(eq, a, b)

    gidx = torch.arange(H, device=x.device) // (H // G)
    xc, dtc = chunks(x), chunks(dt)                    # [B,nc,Q,H,P], [B,nc,Q,H]
    Bc, Cc = chunks(Bm)[:, :, :, gidx], chunks(Cm)[:, :, :, gidx]  # [B,nc,Q,H,N]
    Af = A.to(F32).expand(Bsz, H)
    cs = torch.cumsum(dtc * Af[:, None, None, :], dim=2)  # [B,nc,Q,H]
    total = cs[:, :, -1]                               # [B,nc,H]

    # phase 1: each chunk's own state contribution and its decay
    w = torch.exp(total[:, :, None] - cs) * dtc
    s = mm("bcjhp,bcjhn->bchpn", xc * w[..., None], Bc, split_a=True)
    decay = torch.exp(total)
    # phase 2: the state each chunk starts from
    h = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = decay[:, c, :, None, None] * h + s[:, c]
    hs = torch.stack(starts, dim=1)                    # [B,nc,H,P,N]
    # phase 3: y
    cb = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    csh = cs.movedim(3, 2)                             # [B,nc,H,Q]
    diff = csh[..., :, None] - csh[..., None, :]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal, diff, float("-inf")))
    scores = cb * L * dtc.movedim(3, 2)[..., None, :]
    y = mm("bchij,bcjhp->bcihp", scores, xc, split_a=True)
    y = y + torch.exp(cs)[..., None] * mm("bcihn,bchpn->bcihp", Cc, hs, split_b=True)
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype)
    return (y, h) if return_state else y


def swiglu_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """silu(x @ wg) * (x @ wu), f32 accumulation."""
    g = torch.einsum("md,df->mf", x.to(F32), wg.to(F32))
    u = torch.einsum("md,df->mf", x.to(F32), wu.to(F32))
    return (F.silu(g) * u).to(x.dtype)


def swiglu_derivative(g: torch.Tensor, u: torch.Tensor, dout: torch.Tensor,
                      dtype: torch.dtype):
    """(dg, du) of silu(g) ⊙ u at ``dout``, from g and u in f32 (or f64):
    s = σ(g), du = dout g s, dg = dout u s (1 + g (1 - s)), in ``dtype``."""
    d = dout.to(g.dtype)
    s = torch.sigmoid(g)
    return (d * u * s * (1 + g * (1 - s))).to(dtype), (d * g * s).to(dtype)


def swiglu_bwd_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dout: torch.Tensor):
    """(dg, du) of silu(x wg) ⊙ (x wu) at ``dout``, as the ``wgmma_bwd``
    kernel computes them: g = x wg and u = x wu in f32 (f64 for f64 inputs),
    then :func:`swiglu_derivative`, in x's dtype.  One product or a leading
    expert dim."""
    acc = torch.promote_types(x.dtype, F32)
    xf = x.to(acc)
    return swiglu_derivative(torch.matmul(xf, wg.to(acc)), torch.matmul(xf, wu.to(acc)), dout,
                             x.dtype)


def swiglu_experts_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """out[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]) for x [E, M, D] and wg,
    wu [E, D, F], f32 accumulation."""
    g = torch.einsum("emd,edf->emf", x.to(F32), wg.to(F32))
    u = torch.einsum("emd,edf->emf", x.to(F32), wu.to(F32))
    return (F.silu(g) * u).to(x.dtype)
