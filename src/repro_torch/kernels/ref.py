"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``: the same functions with f32 accumulation.
The kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card; :func:`flash_attention_bwd_ref`
and :func:`swiglu_bwd_ref` are the backward kernels'
(:func:`flash_attention_bwd_tiles` emulates ``wgmma_bwd``'s tiling of the
former, for the tests); the ``"vjp"``
backward routes (f32, and shapes the kernels do not take) compute through
the former and share :func:`swiglu_derivative` with the latter.  Beside them,
:func:`ssd_scan_three_phase` emulates the ``wgmma`` SSD-scan kernel's
decomposition and operand rounding on the CPU, for the tests, and
:func:`ssd_scan_bwd_phases` its backward ``wgmma_bwd``'s.
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
    from the forward's output ``o`` and its ``lse``, as the ``wgmma_bwd``
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


def flash_attention_bwd_tiles(q, k, v, o, lse, do, causal: bool = True,
                              scale: Optional[float] = None, *, bq: int = 64, bk: int = 128,
                              bkq: int = 64, drop_q_tile: Optional[int] = None):
    """The ``wgmma_bwd`` kernels' tiling of :func:`flash_attention_bwd_ref`
    on the CPU, in f32 (f64 for f64 inputs), for the tests: (dq, dk, dv) in
    the inputs' dtypes.

    q, do, lse and delta are zero-padded to whole 128-row tiles, k and v to
    whole ``bk``-key tiles, as TMA zero-fills the kernels' loads.  dK/dV:
    per ``bk`` keys, halves of 64 keys (the two warpgroups) walk the query
    tiles of ``bq`` rows from the causal diagonal on (when causal and Sq <=
    Sk), a half skipping a tile whose every pair is masked or whose keys
    are all past Sk; P = exp2(S·scale·log2 e - lse·log2 e) and dS = P ⊙ (dP
    - delta) are masked only in tiles that reach past an end or the
    diagonal (a masked pair dS = 0 and P = 0, or 1/Sk in a row that sees no
    key).  dQ: per 128 rows, halves of 64 rows each sum dS K over the key
    tiles of ``bkq`` in order, up to their own diagonal.  ``drop_q_tile``
    (a planted fault) has the dK/dV walk skip that query tile."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    acc = torch.promote_types(q.dtype, F32)
    log2e = 1.4426950408889634
    BH, Sq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    off = Sk - Sq
    Sqp, Skp = -(-Sq // 128) * 128, -(-Sk // bk) * bk

    def pad(t, n):
        t = t.to(acc)
        return F.pad(t, (0, 0) * (t.dim() == 3) + (0, n - t.shape[1]))

    qf, dof = pad(q, Sqp), pad(do, Sqp)
    kf, vf = pad(k, Skp), pad(v, Skp)
    delta = pad((do.to(acc) * o.to(acc)).sum(-1), Sqp)
    lse2 = pad(lse.to(acc) * log2e, Sqp)
    dq, dk, dv = (torch.zeros_like(t) for t in (qf, kf, vf))

    def block(r0, nr, c0, nc):
        """P and dS [BH, nr, nc] of rows r0.., keys c0.., as a tile computes them."""
        rows, keys = slice(r0, r0 + nr), slice(c0, c0 + nc)
        s = torch.einsum("bqd,bkd->bqk", qf[:, rows], kf[:, keys])
        dp = torch.einsum("bqd,bkd->bqk", dof[:, rows], vf[:, keys])
        p = torch.exp2(s * (sc * log2e) - lse2[:, rows, None])
        ds = p * (dp - delta[:, rows, None])
        row = torch.arange(r0, r0 + nr)[:, None]
        key = torch.arange(c0, c0 + nc)[None, :]
        edge = r0 + nr > Sq or c0 + nc > Sk or (causal and r0 + off < c0 + nc - 1)
        if edge:
            out = (key >= Sk) | (row >= Sq)
            hidden = ~out & (key > row + off) if causal else torch.zeros_like(out)
            blind = hidden & (row + off < 0)
            p = torch.where(out | hidden, 0.0, p)
            p = torch.where(blind, 1.0 / Sk, p)
            ds = torch.where(out | hidden, 0.0, ds)
        return p, ds

    for k0 in range(0, Skp, bk):
        t0 = max(0, k0 - off) // bq if causal and off >= 0 else 0
        for t in range(t0, -(-Sq // bq)):
            q0 = t * bq
            if t == drop_q_tile:
                continue
            for kw0 in range(k0, k0 + bk, 64):
                if kw0 >= Sk or (causal and off >= 0 and q0 + bq - 1 + off < kw0):
                    continue
                p, ds = block(q0, bq, kw0, 64)
                rows, keys = slice(q0, q0 + bq), slice(kw0, kw0 + 64)
                dv[:, keys] += torch.einsum("bqk,bqd->bkd", p, dof[:, rows])
                dk[:, keys] += torch.einsum("bqk,bqd->bkd", ds, qf[:, rows])
    n_kt = -(-Sk // bkq)
    for qw0 in range(0, Sq, 64):
        n_w = n_kt
        if causal and off >= 0:
            n_w = min(n_w, (min(qw0 + 64, Sq) - 1 + off) // bkq + 1)
        rows = slice(qw0, qw0 + 64)
        for t in range(n_w):  # the kernel's order
            _, ds = block(qw0, 64, t * bkq, bkq)
            dq[:, rows] += torch.einsum("bqk,bkd->bqd", ds, kf[:, t * bkq:(t + 1) * bkq])
    return ((dq[:, :Sq] * sc).to(q.dtype), (dk[:, :Sk] * sc).to(k.dtype),
            dv[:, :Sk].to(v.dtype))


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


def ssd_scan_bwd_phases(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]     (f32)
    A: torch.Tensor,   # [H] or [B, H] (f32)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    dy: torch.Tensor,  # [B, S, H, P]
    dh_final: Optional[torch.Tensor] = None,  # [B, H, P, N]
    lo: bool = True,
):
    """The ``wgmma_bwd`` kernel's arithmetic on the CPU, for the tests (the
    plain version it is held against on the card is
    ``kernels/ssd_scan.py::ssd_scan_vjp``).  (dx, ddt, dA, dB, dC) of the
    scan at the cotangents ``dy`` and ``dh_final`` (``None``: zero), over
    chunks of 64 positions, head h reading group h // (H/G), in the kernel's
    phases:

    0. the chunk-start states h0, as the forward's phases 1 and 2;
    1. r_c = (dy∘exp(cs))^T C, and the cotangent of each chunk's end state
       carried backwards: dh1(last) = dh_final, dh1(c-1) = exp(T_c) dh1(c) + r_c;
    2. per (chunk, head): CB = C B^T, G = dy x^T, L_ij = exp(cs_i - cs_j)
       (j <= i), K = CB∘L, dCB = L∘G∘dt_j, M = CB∘dCB;
       dC = exp(cs_i)(dy h0) + dCB B,  dB = dt_j exp(T - cs_j)(x dh1) + dCB^T C;
       du^T = dy^T K + exp(T - cs_j)(dh1 B^T);
       dcs_i = Σ_j M_ij - Σ_j M_ji + exp(cs_i) dy_i·(h0 C_i) - W_i with
       W_j = dt_j exp(T - cs_j) x_j·(dh1 B_j), and d T = Σ W + exp(T) Σ dh1∘h0
       added to the last position; da = the reverse cumsum of dcs;
       dx = dt du, ddt = x·du + A da, the chunk's share of dA = Σ dt da;
    3. dB and dC summed over the heads of a group, head by head in order;
       dA over the chunks in order.

    In f32 every f32 operand of a product enters as hi + lo bf16 halves, as
    the kernel feeds the tensor cores (``lo=False`` drops the lo halves: a
    planted fault); f64 inputs compute in f64 with no split (the phases'
    algebra, exact).  Returns dx in x's dtype, ddt and dA ([B, H]) in f32
    (f64), dB and dC in B's dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    acc = torch.promote_types(x.dtype, F32)
    Q = 64
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # [B, S, k, ...] -> [B, nc, k, Q, ...], zero past S
        t = F.pad(t.to(acc), [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(Bsz, nc, Q, *t.shape[2:]).movedim(2, 3)

    def parts(t):
        if acc == torch.float64:
            return (t,)
        hi, low = _split_bf16(t)
        return (hi, low) if lo else (hi,)

    def mm(eq, a, b):
        """einsum with whichever of a, b is a tuple of halves summed over."""
        if isinstance(a, tuple):
            return sum(torch.einsum(eq, t, b) for t in a)
        if isinstance(b, tuple):
            return sum(torch.einsum(eq, a, t) for t in b)
        return torch.einsum(eq, a, b)

    gidx = torch.arange(H, device=x.device) // R
    xc, dyc = chunks(x), chunks(dy)                    # [B,nc,H,Q,P]
    dtc = chunks(dt[..., None])[..., 0]                # [B,nc,H,Q]
    Bc, Cc = chunks(Bm)[:, :, gidx], chunks(Cm)[:, :, gidx]  # [B,nc,H,Q,N]
    Ah = A.to(acc).expand(Bsz, H)[:, None, :, None]    # [B,1,H,1]
    cs = torch.cumsum(dtc * Ah, dim=-1)
    T = cs[..., -1:]
    decay = torch.exp(T[..., 0])                       # [B,nc,H]
    ecs, wexp = torch.exp(cs), torch.exp(T - cs)
    # phase 0: the states the chunks start from
    s = mm("bchjp,bchjn->bchpn", parts(xc * (wexp * dtc)[..., None]), Bc)
    h = torch.zeros_like(s[:, 0])
    h0 = torch.empty_like(s)
    for c in range(nc):
        h0[:, c] = h
        h = decay[:, c, :, None, None] * h + s[:, c]
    # phase 1: the cotangents of the states they end with
    r = mm("bchip,bchin->bchpn", parts(dyc * ecs[..., None]), Cc)
    dh = torch.zeros_like(r[:, 0]) if dh_final is None else dh_final.to(acc)
    dh1 = torch.empty_like(r)
    for c in reversed(range(nc)):
        dh1[:, c] = dh
        dh = decay[:, c, :, None, None] * dh + r[:, c]
    # phase 2: within each chunk
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~causal, float("-inf")))
    CB = torch.einsum("bchin,bchjn->bchij", Cc, Bc)
    K = CB * L
    dCB = L * torch.einsum("bchip,bchjp->bchij", dyc, xc) * dtc[..., None, :]
    M = CB * dCB
    dCh = (ecs[..., None] * mm("bchip,bchpn->bchin", dyc, parts(h0))
           + mm("bchij,bchjn->bchin", parts(dCB), Bc))
    dBh = ((dtc * wexp)[..., None] * mm("bchjp,bchpn->bchjn", xc, parts(dh1))
           + mm("bchij,bchin->bchjn", parts(dCB), Cc))
    h0C = mm("bchpn,bchin->bchpi", parts(h0), Cc)
    dhB = mm("bchpn,bchjn->bchpj", parts(dh1), Bc)
    W = dtc * wexp * torch.einsum("bchjp,bchpj->bchj", xc, dhB)
    duT = mm("bchip,bchij->bchpj", dyc, parts(K)) + wexp[..., None, :] * dhB
    dcs = M.sum(-1) - M.sum(-2) + ecs * torch.einsum("bchip,bchpi->bchi", dyc, h0C) - W
    dcs[..., -1] += W.sum(-1) + decay * (dh1 * h0).sum((-1, -2))
    da = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = torch.einsum("bchjp,bchpj->bchj", xc, duT) + Ah * da
    dx = dtc[..., None] * duT.transpose(-1, -2)
    # phase 3: fixed-order sums over the heads of a group and over chunks
    dA = torch.zeros((Bsz, H), dtype=acc, device=x.device)
    for c in range(nc):
        dA = dA + (dtc[:, c] * da[:, c]).sum(-1)
    dBh, dCh = (t.reshape(Bsz, nc, G, R, Q, N) for t in (dBh, dCh))
    dB, dC = dBh[:, :, :, 0], dCh[:, :, :, 0]
    for rr in range(1, R):  # head h = g·R + r of group g
        dB, dC = dB + dBh[:, :, :, rr], dC + dCh[:, :, :, rr]

    def unchunks(t):  # [B, nc, k, Q, ...] -> [B, S, k, ...]
        t = t.movedim(3, 2)
        return t.reshape(Bsz, nc * Q, *t.shape[3:])[:, :S]

    return (unchunks(dx).to(x.dtype), unchunks(ddt[..., None])[..., 0], dA,
            unchunks(dB).to(Bm.dtype), unchunks(dC).to(Cm.dtype))


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
