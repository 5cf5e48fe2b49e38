"""Plain PyTorch versions of the port's kernels (the allclose targets).

Port of ``repro/kernels/ref.py``: the same functions with f32 accumulation.
The kernel wrappers take them for CPU tensors, and ``chip_smoke.py`` holds
each CUDA kernel against them on the card; :func:`flash_attention_bwd_ref`
and :func:`swiglu_bwd_ref` are the backward kernels'
(:func:`flash_attention_bwd_tiles` emulates ``wgmma_bwd``'s tiling of the
former, :func:`swiglu_bwd_tiles` the SwiGLU ``wgmma_bwd``'s walk and
epilogue buffers, for the tests); the ``"vjp"``
backward routes (f32, and shapes the kernels do not take) compute through
the former and share :func:`swiglu_derivative` with the latter.  Beside them,
:func:`ssd_scan_three_phase` emulates the ``wgmma`` SSD-scan kernel's
decomposition and operand rounding on the CPU, for the tests, and
:func:`ssd_scan_bwd_phases` its backward ``wgmma_bwd``'s;
:func:`swiglu_ksplit_ref` the SwiGLU ``cuda_core`` small class's split sum,
:func:`flash_attention_blocked_ref` the flash ``cuda_core`` kernel's blocked
online softmax.  :func:`causal_conv_ref` is the Mamba-2 mixer's conv, bias
and SiLU as the model computed them in eager passes before
``csrc/causal_conv.cu`` (which has no TPU counterpart).
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


def flash_attention_blocked_ref(q, k, v, causal: bool = True, scale: Optional[float] = None, *,
                                bk: int = 64, alpha: bool = True) -> torch.Tensor:
    """softmax(q kᵀ · scale) v as the ``cuda_core`` kernel computes it, in f32,
    for the tests: [BH, Sq, Dv] in q's dtype.

    Each block of 32 query rows (two warps') needs the key tiles of ``bk``
    up to the tile that holds its last row's diagonal when causal and its
    first row sees a key (a tile past every row's diagonal adds exactly
    zero), else all of them.  Two running softmaxes walk them, one the even
    tiles and one the odd, in order.  Per tile: x = S · (scale·log2 e) in
    f32, -inf past Sk and the reference's finite -1e30·log2 e above the
    diagonal; m' = max(m, rowmax x), α = exp2(m - m'), P = exp2(x - m'), l
    = l α + rowsum P, acc = acc α + P V.  The two merge at the larger max M:
    l = l₀ 2^(m₀-M) + l₁ 2^(m₁-M), acc likewise; out = acc / l.  A row that
    sees no key gets the uniform weights over the real keys, as the
    reference.  ``alpha=False`` (a planted fault) leaves the accumulators
    unscaled as a walk goes on."""
    sc = scale if scale is not None else q.shape[-1] ** -0.5
    sl2 = torch.tensor(sc, dtype=F32) * torch.tensor(1.4426950408889634, dtype=F32)
    masked = torch.tensor(NEG_INF, dtype=F32) * torch.tensor(1.4426950408889634, dtype=F32)
    BH, Sq, _ = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    off = Sk - Sq
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    rows = torch.arange(Sq, device=q.device)
    first = rows // 32 * 32  # each row's block's first and last rows
    last = torch.clamp(first + 31, max=Sq - 1)
    n_all = -(-Sk // bk)
    if causal:
        need = torch.clamp(torch.div(last + off, bk, rounding_mode="floor") + 1, max=n_all)
        tiles = torch.where(first + off >= 0, need, torch.full_like(need, n_all))
    else:
        tiles = torch.full_like(rows, n_all)
    walks = []
    for half in (0, 1):
        m = torch.full((BH, Sq), -float("inf"), dtype=F32, device=q.device)
        l = torch.zeros((BH, Sq), dtype=F32, device=q.device)
        acc = torch.zeros((BH, Sq, Dv), dtype=F32, device=q.device)
        for t in range(half, n_all, 2):
            keys = torch.arange(t * bk, min((t + 1) * bk, Sk), device=q.device)
            x = torch.einsum("bqd,bkd->bqk", qf, kf[:, keys]) * sl2
            if causal:
                x = torch.where(keys[None, :] > rows[:, None] + off, masked, x)
            live = (t < tiles)[None, :]  # rows whose block reaches this tile
            m_new = torch.where(live, torch.maximum(m, x.amax(-1)), m)
            a = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = torch.where(live, l * a + p.sum(-1), l)
            pv = torch.einsum("bqk,bkd->bqd", p, vf[:, keys])
            acc = torch.where(live[..., None], (acc * a[..., None] if alpha else acc) + pv, acc)
            m = m_new
        walks.append((m, l, acc))
    (m0, l0, acc0), (m1, l1, acc1) = walks
    mx = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - mx), torch.exp2(m1 - mx)  # a walk with no tile: 0
    l = l0 * a0 + l1 * a1
    acc = acc0 * a0[..., None] + acc1 * a1[..., None]
    return (acc / l[..., None]).to(q.dtype)


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
    chunk: int = 64,
    split: bool = True,
):
    """The chunk-parallel kernels' arithmetic on the CPU, for the tests (not
    a plain version: that is :func:`ssd_scan_ref`).  Their three phases over
    chunks of ``chunk`` positions, head h reading group h // (H/G):

    1. s_c = (x∘w)^T B with w_j = exp(cs_Q - cs_j) dt_j, and decay_c = exp(cs_Q);
    2. h_0 = 0, h_{c+1} = decay_c h_c + s_c;
    3. y = (C B^T ∘ L ∘ dt) x + exp(cs) ∘ (C h_c^T).

    The defaults are the ``wgmma`` kernel's: chunks of 64, and each f32
    operand it feeds to the bf16 tensor cores (x∘w, the masked scores, h_c)
    entering as hi + lo bf16 halves, two products summed in f32; ``lo=False``
    drops the lo halves (a planted fault).  ``split=False`` is the
    ``cuda_core`` kernel's: every product in f32 on the operands as they are
    (chunks of 64 too).  The inputs x, B and C enter as they are.  Returns y
    [B, S, H, P] in x's dtype and, with ``return_state``, the final state
    [B, H, P, N] in f32."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # [B, S, ...] -> [B, nc, Q, ...], zero past S
        t = F.pad(t.to(F32), [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(Bsz, nc, Q, *t.shape[2:])

    if not split:
        halves = lambda t: (t, None)  # noqa: E731
    elif lo:
        halves = _split_bf16
    else:
        halves = lambda t: (t.to(torch.bfloat16).to(F32), None)  # noqa: E731

    def mm(eq, a, b, split_a=False, split_b=False):
        """einsum in f32 with a or b entering as its hi + lo halves."""
        if split_a:
            hi, low = halves(a)
            return torch.einsum(eq, hi, b) + (0 if low is None else torch.einsum(eq, low, b))
        if split_b:
            hi, low = halves(b)
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


BWD_CLUSTER = 8  # the wgmma_bwd kernel's largest cluster: CTAs that share a group's chunk


def bwd_head_ranks(R: int, ranks: int = BWD_CLUSTER) -> list:
    """The heads of a group (0 .. R - 1) that each CTA of one cluster of the
    ``wgmma_bwd`` kernel's gradient phase takes, in rank order: min(ranks,
    R) ranks, rank k the heads [k R // n, (k + 1) R // n).  The kernel picks
    1 to 8 ranks by what the card holds at once (``grad_ranks`` in
    csrc/ssd_scan.cu); any choice sums the same terms."""
    n = min(ranks, R)
    return [range(k * R // n, (k + 1) * R // n) for k in range(n)]


def ssd_scan_bwd_phases(
    x: torch.Tensor,   # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]     (f32)
    A: torch.Tensor,   # [H] or [B, H] (f32)
    Bm: torch.Tensor,  # [B, S, G, N]
    Cm: torch.Tensor,  # [B, S, G, N]
    dy: torch.Tensor,  # [B, S, H, P]
    dh_final: Optional[torch.Tensor] = None,  # [B, H, P, N]
    lo: bool = True,
    dropped_rank: Optional[int] = None,
    ranks: int = BWD_CLUSTER,
):
    """The ``wgmma_bwd`` kernel's arithmetic on the CPU, for the tests (the
    plain version it is held against on the card is
    ``kernels/ssd_scan.py::ssd_scan_vjp``).  (dx, ddt, dA, dB, dC) of the
    scan at the cotangents ``dy`` and ``dh_final`` (``None``: zero), over
    chunks of 64 positions, head h reading group h // (H/G), in the kernel's
    phases:

    1. the state pass, both directions: the chunk-start states h0 (h0(0) =
       0, h0(c+1) = exp(T_c) h0(c) + (x∘w)^T B with w_j = exp(T - cs_j) dt_j)
       and the cotangents of the chunk-end states (dh1(last) = dh_final,
       dh1(c-1) = exp(T_c) dh1(c) + (dy∘exp(cs))^T C), each carried in f32
       and kept as its bf16 hi and lo halves;
    2. per (chunk, group) a cluster of ``bwd_head_ranks(H/G, ranks)`` CTAs,
       each walking its heads in order: CB = C B^T once; per head G = dy x^T,
       L_ij = exp(cs_i - cs_j) (j <= i), K = CB∘L, dCB = L∘G∘dt_j, M =
       CB∘dCB; the state terms of dC and dB summed over the CTA's heads,
       dC_s += exp(cs_i) (dy h0)_i and dB_s += dt_j exp(T - cs_j) (x dh1)_j
       (each head's product, then its rows scaled into the sum); dCB summed
       over the CTA's heads; du^T = dy^T
       K + exp(T - cs_j)(dh1 B^T); dcs_i = Σ_j M_ij - Σ_j M_ji + exp(cs_i)
       dy_i·(h0 C_i) - W_i with W_j = dt_j exp(T - cs_j) x_j·(dh1 B_j), and
       d T = Σ W + exp(T) Σ dh1∘h0 (from the halves) added to the last
       position; da = the reverse cumsum of dcs; dx = dt du, ddt = x·du +
       A da, the chunk's share of dA = Σ dt da.  Then each CTA's dC = dC_s +
       (Σ dCB) B and dB = dB_s + (Σ dCB)^T C;
    3. dB and dC summed over the cluster's ranks in rank order; dA over the
       chunks in order.

    In f32 every f32 operand of a product enters as hi + lo bf16 halves, as
    the kernel feeds the tensor cores (``lo=False`` drops the lo halves: a
    planted fault); f64 inputs compute in f64 with no split (the phases'
    algebra, exact).  ``dropped_rank`` leaves that rank's share out of the
    sum over ranks (a planted fault; the kernel's own is in
    ``chip_smoke.py``).  Returns dx in x's dtype, ddt and dA ([B, H]) in f32
    (f64), dB and dC in B's dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    acc = torch.promote_types(x.dtype, F32)
    exact = acc == torch.float64
    Q = 64
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # [B, S, k, ...] -> [B, nc, k, Q, ...], zero past S
        t = F.pad(t.to(acc), [0, 0] * (t.ndim - 2) + [0, pad])
        return t.reshape(Bsz, nc, Q, *t.shape[2:]).movedim(2, 3)

    def parts(t):
        if exact:
            return (t,)
        hi, low = _split_bf16(t)
        return (hi, low) if lo else (hi,)

    def whole(t):
        """The value the kernel holds of a state kept as its halves."""
        return sum(parts(t))

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
    Bg, Cg = chunks(Bm), chunks(Cm)                    # [B,nc,G,Q,N]
    Bc, Cc = Bg[:, :, gidx], Cg[:, :, gidx]            # [B,nc,H,Q,N]
    Ah = A.to(acc).expand(Bsz, H)[:, None, :, None]    # [B,1,H,1]
    cs = torch.cumsum(dtc * Ah, dim=-1)
    T = cs[..., -1:]
    decay = torch.exp(T[..., 0])                       # [B,nc,H]
    ecs, wexp = torch.exp(cs), torch.exp(T - cs)
    # phase 1: the states the chunks start from, and the cotangents of the
    # states they end with
    s = mm("bchjp,bchjn->bchpn", parts(xc * (wexp * dtc)[..., None]), Bc)
    h = torch.zeros_like(s[:, 0])
    h0 = torch.empty_like(s)
    for c in range(nc):
        h0[:, c] = h
        h = decay[:, c, :, None, None] * h + s[:, c]
    r = mm("bchip,bchin->bchpn", parts(dyc * ecs[..., None]), Cc)
    dh = torch.zeros_like(r[:, 0]) if dh_final is None else dh_final.to(acc)
    dh1 = torch.empty_like(r)
    for c in reversed(range(nc)):
        dh1[:, c] = dh
        dh = decay[:, c, :, None, None] * dh + r[:, c]
    # phase 2: within each chunk, per head
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(~causal, float("-inf")))
    CB = torch.einsum("bchin,bchjn->bchij", Cc, Bc)
    K = CB * L
    dCB = L * torch.einsum("bchip,bchjp->bchij", dyc, xc) * dtc[..., None, :]
    M = CB * dCB
    dCs = ecs[..., None] * mm("bchip,bchpn->bchin", dyc, parts(h0))
    dBs = (dtc * wexp)[..., None] * mm("bchjp,bchpn->bchjn", xc, parts(dh1))
    h0C = mm("bchpn,bchin->bchpi", parts(h0), Cc)
    dhB = mm("bchpn,bchjn->bchpj", parts(dh1), Bc)
    W = dtc * wexp * torch.einsum("bchjp,bchpj->bchj", xc, dhB)
    duT = mm("bchip,bchij->bchpj", dyc, parts(K)) + wexp[..., None, :] * dhB
    dcs = M.sum(-1) - M.sum(-2) + ecs * torch.einsum("bchip,bchpi->bchi", dyc, h0C) - W
    dcs[..., -1] += W.sum(-1) + decay * (whole(dh1) * whole(h0)).sum((-1, -2))
    da = dcs.flip(-1).cumsum(-1).flip(-1)
    ddt = torch.einsum("bchjp,bchpj->bchj", xc, duT) + Ah * da
    dx = dtc[..., None] * duT.transpose(-1, -2)
    # each CTA's sums over its heads in order, then over the ranks in order
    dCs, dBs, dCB = (t.reshape(Bsz, nc, G, R, *t.shape[3:]) for t in (dCs, dBs, dCB))
    dB = dC = 0
    for k, heads in enumerate(bwd_head_ranks(R, ranks)):
        dcb, dc, db = dCB[:, :, :, heads[0]], dCs[:, :, :, heads[0]], dBs[:, :, :, heads[0]]
        for rr in heads[1:]:
            dcb, dc, db = dcb + dCB[:, :, :, rr], dc + dCs[:, :, :, rr], db + dBs[:, :, :, rr]
        dc = dc + mm("bcgij,bcgjn->bcgin", parts(dcb), Bg)
        db = db + mm("bcgij,bcgin->bcgjn", parts(dcb), Cg)
        if k != dropped_rank:
            dB, dC = dB + db, dC + dc
    # phase 3: dA over the chunks in order
    dA = torch.zeros((Bsz, H), dtype=acc, device=x.device)
    for c in range(nc):
        dA = dA + (dtc[:, c] * da[:, c]).sum(-1)

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


def swiglu_ksplit_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, bk: int,
                      ksplit: int) -> torch.Tensor:
    """silu(x wg) (x wu) with each product summed as the ``cuda_core``
    kernel's small class sums it: k group s of ``ksplit`` takes k rows [s
    bk / ksplit, (s + 1) bk / ksplit) of every stage of ``bk`` rows, each
    group's partial in f32 (f64 for f64 inputs), then the partials added in
    group order.  One product or a leading expert dim."""
    acc = torch.promote_types(x.dtype, F32)
    group = torch.arange(x.shape[-1]) % bk // (bk // ksplit)
    g = u = None
    for s in range(ksplit):
        rows = group == s
        xs = x[..., rows].to(acc)
        pg, pu = xs @ wg[..., rows, :].to(acc), xs @ wu[..., rows, :].to(acc)
        g, u = (pg, pu) if g is None else (g + pg, u + pu)
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


# The SwiGLU backward kernel's layout (csrc/swiglu_matmul.cu, namespace
# prefill), in the key order of its C function swiglu_matmul_bwd_layout,
# which a card test holds equal to this: the ring's stages; the epilogue
# buffers beside them of the two- and of the three-consumer tile (two where
# they fit: dout then dg over it, and du; else one); the buffer dout lands
# in; an epilogue box's rows (a warpgroup's) and columns (a 128-byte swizzle
# atom); the two-consumer tile (the expert entry's too); the three-consumer
# tile; the two-consumer backward's dynamic shared memory in bytes.
SWIGLU_BWD_LAYOUT = {"stages": 4, "epi_bufs2": 1, "epi_bufs3": 2, "dout_buf": 0, "box_rows": 64,
                     "box_cols": 64, "bm2": 128, "bn2": 128, "bm3": 192, "bn3": 64,
                     "smem2": 230496}


def swiglu_bwd_tile_shape(M: int, F: int, experts: bool, sms: int = 132) -> tuple:
    """(BM, BN) of the backward's tiles: the expert entry's two-consumer
    tile, else the dispatcher's choice between the two (waves of one CTA an
    SM times the tile's area, the larger tile on a tie)."""
    L = SWIGLU_BWD_LAYOUT
    two, three = (L["bm2"], L["bn2"]), (L["bm3"], L["bn3"])
    if experts:
        return two

    def cost(bm, bn):
        return -(-(-(-M // bm) * -(-F // bn)) // sms) * bm * bn
    return three if cost(*three) < cost(*two) else two


def swiglu_bwd_tiles(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, dout: torch.Tensor, *,
                     sms: int = 132, read_other: bool = False):
    """The ``wgmma_bwd`` kernel's walk and epilogue on the CPU, for the
    tests: (dg, du, writes, walk).  x [M, D] (or [E, M, D] for the expert
    entry), wg, wu [D, F] ([E, D, F]), dout [M, F] ([E, M, F]).

    The grid is min(tiles, ``sms``) CTAs; CTA b takes tiles b, b + grid, ...
    in order, tile t at m tile t % mtiles, n tile t / mtiles % ncols, expert
    t / (mtiles ncols).  Each tile's g = x wg and u = x wu are computed in
    f32 (f64 for f64 inputs) from operands zero-padded to whole tiles, as
    TMA zero-fills the kernel's loads.  Each consumer warpgroup (64 rows)
    keeps its own boxes of [64 rows, 64 columns] in the CTA's epilogue
    buffers; its dout lands in buffer ``dout_buf`` (zero-filled past M and
    F) and :func:`swiglu_derivative` gives dg and du.  With two buffers dg
    goes over dout and du into the second, and every box is stored; with
    one (two boxes a warpgroup), box 0 takes dg and box 1 du of columns
    0-63 (box 1's dout waits in registers), both are stored, then the two
    boxes take columns 64-127's dg and du and are stored again.  A store
    writes the part of its box inside M, F and its expert.  ``read_other``
    (a planted fault, one-buffer tiles only) reads columns 0-63's dout from
    box 1, the other box of the buffer.

    ``writes`` [2, E, M, F] counts the stores into each element of dg and
    du; ``walk`` lists each tile as a dict: CTA, its index j on the CTA, the
    tile, expert, m0, n0, the buffer its dout lands in, the parity of the
    mbarrier phase it waits on (j % 2), and its store boxes (warpgroup,
    rows, columns), each box once for dg and once for du."""
    L = SWIGLU_BWD_LAYOUT
    experts = x.dim() == 3
    xs, wgs, wus, ds = (t if experts else t[None] for t in (x, wg, wu, dout))
    E, M, D = xs.shape
    Fd = wgs.shape[-1]
    acc = torch.promote_types(x.dtype, F32)
    BM, BN = swiglu_bwd_tile_shape(M, Fd, experts, sms)
    R, C = L["box_rows"], L["box_cols"]
    cons, na = BM // R, BN // C
    nbufs = L["epi_bufs2"] if BM == L["bm2"] else L["epi_bufs3"]
    if read_other and nbufs != 1:
        raise ValueError("read_other: a one-buffer tile's fault")
    mtiles, ncols = -(-M // BM), -(-Fd // BN)
    ntiles = E * mtiles * ncols
    grid = min(ntiles, sms)
    Mp, Fp = mtiles * BM, ncols * BN
    xp = F.pad(xs.to(acc), (0, 0, 0, Mp - M))
    wgp, wup = (F.pad(w.to(acc), (0, Fp - Fd)) for w in (wgs, wus))
    dp = F.pad(ds, (0, Fp - Fd, 0, Mp - M))
    dg, du = torch.zeros_like(ds), torch.zeros_like(ds)
    writes = torch.zeros((2, E, M, Fd), dtype=torch.int32)
    walk = []

    def store(box, out, which, e, r0, c0):
        """The part of ``box`` inside M and F, at row r0 and column c0."""
        r1, c1 = min(r0 + R, M), min(c0 + C, Fd)
        if r1 > r0 and c1 > c0:  # a box wholly past M or F writes nothing
            out[e, r0:r1, c0:c1] = box[:r1 - r0, :c1 - c0]
            writes[which, e, r0:r1, c0:c1] += 1

    for b in range(grid):
        for j, t in enumerate(range(b, ntiles, grid)):
            m0, n0, e = t % mtiles * BM, t // mtiles % ncols * BN, t // (mtiles * ncols)
            xt = xp[e, m0:m0 + BM]
            g, u = xt @ wgp[e][:, n0:n0 + BN], xt @ wup[e][:, n0:n0 + BN]
            boxes = []
            for w in range(cons):
                rows, r0 = slice(w * R, (w + 1) * R), m0 + w * R
                d = dp[e, r0:r0 + R, n0:n0 + BN]  # the warpgroup's dout boxes, side by side
                if read_other:
                    d = torch.cat([d[:, C:], d[:, C:]], dim=1)
                dgw, duw = swiglu_derivative(g[rows], u[rows], d, x.dtype)
                for a in range(na):
                    cols = slice(a * C, (a + 1) * C)
                    store(dgw[:, cols], dg, 0, e, r0, n0 + a * C)
                    store(duw[:, cols], du, 1, e, r0, n0 + a * C)
                    boxes.append((w, (r0, min(r0 + R, M)), (n0 + a * C, min(n0 + (a + 1) * C, Fd))))
            walk.append(dict(cta=b, j=j, tile=t, expert=e, m0=m0, n0=n0,
                             dout_buf=L["dout_buf"], parity=j % 2, boxes=boxes))
    if not experts:
        dg, du = dg[0], du[0]
    return dg, du, writes, walk


def swiglu_experts_ref(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor) -> torch.Tensor:
    """out[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e]) for x [E, M, D] and wg,
    wu [E, D, F], f32 accumulation."""
    g = torch.einsum("emd,edf->emf", x.to(F32), wg.to(F32))
    u = torch.einsum("emd,edf->emf", x.to(F32), wu.to(F32))
    return (F.silu(g) * u).to(x.dtype)


def causal_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    carry: Optional[torch.Tensor] = None):
    """silu(depthwise causal conv + bias) over x [B, S, CH] with taps w [W, CH]
    and bias b [CH], the W - 1 positions before x given by ``carry`` [B, W - 1,
    CH] (zeros without), as ``repro/models/ssm.py::_causal_conv``: each tap's
    product and sum in f32, in order from the oldest position.  Returns the
    output in x's dtype and the new window, the last W - 1 positions of
    carry + x, in x's dtype."""
    W = w.shape[0]
    B, S, CH = x.shape
    if carry is None:
        carry = torch.zeros((B, W - 1, CH), dtype=x.dtype, device=x.device)
    padded = torch.cat([carry.to(x.dtype), x], dim=1)
    out = torch.zeros(x.shape, dtype=F32, device=x.device)
    for i in range(W):
        out = out + padded[:, i:i + S].to(F32) * w[i].to(F32)
    out = F.silu(out + b.to(F32)).to(x.dtype)
    return out, padded[:, padded.shape[1] - (W - 1):]
