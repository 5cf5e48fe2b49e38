"""Plain PyTorch reference of the benchmark's language models, in float32.

It imports nothing of the port: it reads a configuration file's ``arch``
object and the weights the benchmark drew (:mod:`port_bench.weights`), by
name, and computes the model as its papers describe it, one layer at a time:

* RMSNorm, then per layer a mixer and an FFN, each added to the residual;
* the Mamba-2 mixer (arXiv:2405.21060): in-projections, a depthwise causal
  convolution with SiLU, the SSD recurrence h_t = exp(dt_t A) h_{t-1} +
  dt_t x_t B_tᵀ, y_t = C_t h_t + D x_t (evaluated chunk by chunk), a gated
  RMSNorm and the out-projection;
* grouped-query causal attention at scale head_dim^-1/2 (rotary embedding
  only where the configuration has a theta), in blocks of queries;
* SwiGLU FFNs, and top-k routed experts with GShard capacity: per routing
  group of ``size`` tokens an expert keeps the first ceil(k·size/E·cf) tokens
  that chose it, in token order, and drops the rest; the kept weights are
  the top-k softmax gates renormalised to sum 1.

Everything is float32 with TF32 off (:func:`exact_f32`).  With
``quant="fp8"`` every product's operands are first rounded to float8 e4m3
(their gradients to e5m2) with one scale a row (activations) or a column
(weights): the control that computes the same model in the precision below
bfloat16.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from port_bench.archcfg import layer_kinds

F32 = torch.float32
Q_BLOCK = 512    # query rows of one attention block
SSD_CHUNK = 64   # the SSD's chunk length (any length gives the same values)


@contextlib.contextmanager
def exact_f32():
    """float32 products as float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _round(t: torch.Tensor, dim: int, dtype: torch.dtype, top: float) -> torch.Tensor:
    s = top / t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    return (t * s).to(dtype).to(F32) / s


class _FP8(torch.autograd.Function):
    """Operands rounded to float8 e4m3 going forward and their gradients to
    e5m2 going back, each with one scale per slice along ``dim`` (the
    slice's largest magnitude maps to the format's largest finite value)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim = dim
        return _round(t, dim, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dim, torch.float8_e5m2, 57344.0), None


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` as float8 sees it, back in float32 (see :class:`_FP8`)."""
    return _FP8.apply(t, dim)


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """a [..., K] @ w [K, N] in float32 (w may be stored in bfloat16)."""
    wf = w.to(F32)
    if quant == "fp8":
        a, wf = fp8(a, -1), fp8(wf, 0)
    return a @ wf


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale.to(F32)


# --------------------------------------------------------------------------- #
# Mamba-2
# --------------------------------------------------------------------------- #
def ssd(x, dt, A, Bm, Cm, chunk: int = SSD_CHUNK):
    """The SSD recurrence over x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm
    [B, S, G, N], evaluated chunk by chunk: within a chunk the quadratic
    form, across chunks the carried state.  Returns y [B, S, H, P] and the
    final state [B, H, P, N]."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    pad = (-S) % chunk
    if pad:  # dt = 0 past the end: no input and no decay
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    nc = x.shape[1] // chunk
    rep = H // G
    x = x.reshape(Bsz, nc, chunk, H, P)
    dt = dt.reshape(Bsz, nc, chunk, H)
    Bh = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    cs = torch.cumsum(dt * A, dim=2)                                     # [B, c, Q, H]
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]                    # [B, c, t, s, H]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, -math.inf))
    del seg
    CB = torch.einsum("bctgn,bcsgn->bctsg", Cm.reshape(Bsz, nc, chunk, G, N),
                      Bm.reshape(Bsz, nc, chunk, G, N)).repeat_interleave(rep, dim=4)
    W = CB * L * dt[:, :, None, :, :]
    del CB, L
    y = torch.einsum("bctsh,bcshp->bcthp", W, x)
    del W
    to_end = torch.exp(cs[:, :, -1:, :] - cs) * dt                       # [B, c, Q, H]
    states = torch.einsum("bcsh,bcshp,bcshn->bchpn", to_end, x, Bh)
    decay = torch.exp(cs[:, :, -1, :])                                   # [B, c, H]
    h = torch.zeros(Bsz, H, P, N, dtype=F32, device=x.device)
    starts = []
    for c in range(nc):
        starts.append(h)
        h = h * decay[:, c, :, None, None] + states[:, c]
    h0 = torch.stack(starts, dim=1)                                      # [B, c, H, P, N]
    y = y + torch.einsum("bcthn,bchpn->bcthp", Ch, h0) * torch.exp(cs)[..., None]
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S], h


def ssm_mixer(p: Dict, arch: Dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    s = arch["ssm"]
    d = arch["d_model"]
    d_in = s["expand"] * d
    H, P, N, G = d_in // s["head_dim"], s["head_dim"], s["d_state"], s["n_groups"]
    Bsz, S, _ = x.shape
    z = mm(x, p["wz"], quant)
    xBC = torch.cat([mm(x, p["wx"], quant), mm(x, p["wB"], quant), mm(x, p["wC"], quant)], -1)
    dt = F.softplus(mm(x, p["wdt"], quant) + p["dt_bias"])
    w = p["conv_w"].shape[0]
    padded = F.pad(xBC, (0, 0, w - 1, 0))
    conv = sum(padded[:, i:i + S] * p["conv_w"][i].to(F32) for i in range(w))
    conv = F.silu(conv + p["conv_b"].to(F32))
    xh = conv[..., :d_in].reshape(Bsz, S, H, P)
    Bm = conv[..., d_in:d_in + G * N].reshape(Bsz, S, G, N)
    Cm = conv[..., d_in + G * N:].reshape(Bsz, S, G, N)
    if quant == "fp8":
        xh, Bm, Cm = fp8(xh, -1), fp8(Bm, -1), fp8(Cm, -1)
    y, _ = ssd(xh, dt, -torch.exp(p["A_log"]), Bm, Cm)
    y = (y + p["Dskip"][:, None] * xh).reshape(Bsz, S, d_in)
    g = rmsnorm(y * F.silu(z), p["norm"], arch["norm_eps"])
    return mm(g, p["wo"], quant)


# --------------------------------------------------------------------------- #
# attention, SwiGLU, experts
# --------------------------------------------------------------------------- #
def _rope(t: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the two halves of the head dim; t [B, S, H, D]."""
    D = t.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=F32, device=t.device) / D))
    ang = torch.arange(t.shape[1], dtype=F32, device=t.device)[:, None, None] * freqs
    t1, t2 = t.chunk(2, dim=-1)
    return torch.cat([t1 * ang.cos() - t2 * ang.sin(), t2 * ang.cos() + t1 * ang.sin()], -1)


def attention(p: Dict, arch: Dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    H, KV, Dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
    Bsz, S, d = x.shape
    q = mm(x, p["wq"].reshape(d, H * Dh), quant).reshape(Bsz, S, H, Dh)
    k = mm(x, p["wk"].reshape(d, KV * Dh), quant).reshape(Bsz, S, KV, Dh)
    v = mm(x, p["wv"].reshape(d, KV * Dh), quant).reshape(Bsz, S, KV, Dh)
    if arch.get("rope_theta"):
        q, k = _rope(q, arch["rope_theta"]), _rope(k, arch["rope_theta"])
    k, v = k.repeat_interleave(H // KV, dim=2), v.repeat_interleave(H // KV, dim=2)
    if quant == "fp8":
        q, k, v = fp8(q, -1), fp8(k, -1), fp8(v, -1)
    out = torch.empty(Bsz, S, H, Dh, dtype=F32, device=x.device)
    kpos = torch.arange(S, device=x.device)
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, a:b], k[:, :b]) * Dh ** -0.5
        s = s.masked_fill(kpos[None, :b] > torch.arange(a, b, device=x.device)[:, None],
                          -math.inf)
        pr = torch.softmax(s, dim=-1)
        if quant == "fp8":
            pr = fp8(pr, -1)
        out[:, a:b] = torch.einsum("bhqk,bkhd->bqhd", pr, v[:, :b])
    return mm(out.reshape(Bsz, S, H * Dh), p["wo"].reshape(H * Dh, d), quant)


def swiglu(x, wg, wu, wd, quant=None) -> torch.Tensor:
    return mm(F.silu(mm(x, wg, quant)) * mm(x, wu, quant), wd, quant)


def moe(p: Dict, arch: Dict, x: torch.Tensor, groups: Sequence[Tuple[int, int, int]],
        quant=None) -> torch.Tensor:
    """Routed experts over x [B, S, d]; ``groups``: (start, end, size) of
    each routing group along S, ``size`` the token count its capacity is
    computed from."""
    m = arch["moe"]
    E, K = m["n_experts"], m["top_k"]
    gates = torch.softmax(x @ p["router"].to(F32), dim=-1)
    gk, ik = torch.topk(gates, K, dim=-1)                                # [B, S, K]
    gk = gk / gk.sum(-1, keepdim=True)
    keep = torch.zeros_like(ik, dtype=torch.bool)
    for a, b, size in groups:
        cap = max(1, int(K * size / E * m.get("capacity_factor", 1.25) + 0.999))
        chosen = F.one_hot(ik[:, a:b], E).sum(2)                         # [B, n, E]
        rank = torch.cumsum(chosen, dim=1) - 1                           # place in its queue
        keep[:, a:b] = torch.gather(rank, 2, ik[:, a:b]) < cap
    out = torch.zeros_like(x)
    for e in range(E):
        bi, si, ki = torch.nonzero((ik == e) & keep, as_tuple=True)
        if bi.numel() == 0:
            continue
        ye = swiglu(x[bi, si], p["wg"][e], p["wu"][e], p["wd"][e], quant)
        out.index_put_((bi, si), ye * gk[bi, si, ki][:, None], accumulate=True)
    return out


# --------------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------------- #
def prefill_groups(arch: Dict, S: int) -> List[Tuple[int, int, int]]:
    """Routing groups of a whole-sequence pass over S tokens: chunks of
    ``router_chunk`` (the last one padded to that size)."""
    if arch.get("moe") is None:
        return []
    chunk = min(arch["moe"].get("router_chunk", 1024), S)
    return [(a, min(a + chunk, S), chunk) for a in range(0, S, chunk)]


def serve_groups(arch: Dict, prompt: int, decoded: int) -> List[Tuple[int, int, int]]:
    """Routing groups of a served request: the prompt as one prefill, then
    each decoded token alone."""
    return prefill_groups(arch, prompt) + [(t, t + 1, 1) for t in range(prompt, prompt + decoded)]


def layer(W: Dict, arch: Dict, i: int, kind: Tuple[str, str], x: torch.Tensor, groups,
          quant=None) -> torch.Tensor:
    mixer, ffn = kind
    pre = f"layers.{i}."
    p = {k[len(pre):]: v for k, v in W.items() if k.startswith(pre)}
    sub = lambda name: {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith(name + ".")}
    h = rmsnorm(x, p["ln1.scale"], arch["norm_eps"])
    x = x + (ssm_mixer(sub("ssm"), arch, h, quant) if mixer == "ssm"
             else attention(sub("attn"), arch, h, quant))
    if ffn == "none":
        return x
    h = rmsnorm(x, p["ln2.scale"], arch["norm_eps"])
    if ffn == "dense":
        f = sub("mlp")
        return x + swiglu(h, f["wg"], f["wu"], f["wd"], quant)
    return x + moe(sub("moe"), arch, h, groups, quant)


def logits(W: Dict, arch: Dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    x = rmsnorm(x, W["final_norm.scale"], arch["norm_eps"])
    head = W["embed"].t() if arch.get("tie_embeddings") else W["lm_head"]
    return mm(x, head, quant)


def forward(W: Dict, arch: Dict, tokens: torch.Tensor, groups=None,
            positions: Optional[torch.Tensor] = None, quant=None,
            checkpoint_layers: bool = False) -> torch.Tensor:
    """Logits [B, n, V] in float32 of tokens [B, S] at ``positions`` (all
    when None); ``groups``: the MoE routing groups (whole-sequence chunks
    when None)."""
    groups = prefill_groups(arch, tokens.shape[1]) if groups is None else groups
    x = W["embed"][tokens].to(F32)
    for i, kind in enumerate(layer_kinds(arch)):
        if checkpoint_layers:
            x = torch.utils.checkpoint.checkpoint(layer, W, arch, i, kind, x, groups, quant,
                                                  use_reentrant=False)
        else:
            x = layer(W, arch, i, kind, x, groups, quant)
    if positions is not None:
        x = x[:, positions]
    return logits(W, arch, x, quant)
