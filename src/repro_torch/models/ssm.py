"""Mamba-2 SSD mixer: projections, causal conv, the scan and the gated norm.

Port of ``repro/models/ssm.py``.  Where the reference evaluates the chunked
SSD with ``_ssd_chunked`` (a ``lax.scan`` over chunks) in full and prefill
mode, the port calls the CUDA SSD-scan kernel through ``ops.ssd_mixer``,
which also returns the final state for the prefill cache.  Decode is the
reference's one-token recurrence in plain PyTorch, against a ``[B, H, P, N]``
f32 state and a rolling ``[B, w-1, CH]`` conv window.

Cache writes happen in place: the cache tensors passed in are updated, where
the reference returns new arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.causal_conv import causal_conv
from repro_torch.kernels.ops import ssd_mixer
from repro_torch.parallel.sharding import ParamDef

__all__ = ["ssm_dims", "ssm_defs", "ssm_block", "ssm_cache_defs"]

F32 = torch.float32

Params = Dict[str, torch.Tensor]


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return d_in, n_heads, s.head_dim, s.d_state, s.n_groups


def ssm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "wz": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wx": ParamDef((d, d_in), ("embed", "ssm_inner")),
        "wB": ParamDef((d, G * N), ("embed", None)),
        "wC": ParamDef((d, G * N), ("embed", None)),
        "wdt": ParamDef((d, H), ("embed", "heads")),
        "dt_bias": ParamDef((H,), ("heads",), dtype=F32, init="zeros"),
        "A_log": ParamDef((H,), ("heads",), dtype=F32, init="zeros"),
        "Dskip": ParamDef((H,), ("heads",), dtype=F32, init="ones"),
        "conv_w": ParamDef((s.conv_width, conv_ch), (None, "ssm_inner"),
                           scale=1.0 / s.conv_width),
        "conv_b": ParamDef((conv_ch,), ("ssm_inner",), init="zeros"),
        "norm": ParamDef((d_in,), ("ssm_inner",), init="ones"),
        "wo": ParamDef((d_in, d), ("ssm_inner", "embed")),
    }


def ssm_cache_defs(cfg: ArchConfig, batch: int) -> Dict[str, ParamDef]:
    """The conv window (bf16) and the state (f32) of one mixer."""
    s = cfg.ssm
    d_in, H, P, N, G = ssm_dims(cfg)
    conv_ch = d_in + 2 * G * N
    return {
        "conv": ParamDef((batch, s.conv_width - 1, conv_ch),
                         ("batch", None, "ssm_inner"), dtype=torch.bfloat16,
                         init="zeros"),
        "ssd": ParamDef((batch, H, P, N), ("batch", "heads", None, None),
                        dtype=F32, init="zeros"),
    }


def _project(p: Params, cfg: ArchConfig, x: torch.Tensor):
    """x: [B,S,d] -> (z, xBC, dt) with xBC = concat(x_ssm, B, C)."""
    z = torch.einsum("bsd,de->bse", x, p["wz"])
    xs = torch.einsum("bsd,de->bse", x, p["wx"])
    Bm = torch.einsum("bsd,de->bse", x, p["wB"])
    Cm = torch.einsum("bsd,de->bse", x, p["wC"])
    dt = torch.einsum("bsd,dh->bsh", x, p["wdt"]).to(F32)
    dt = F.softplus(dt + p["dt_bias"])
    return z, torch.cat([xs, Bm, Cm], dim=-1), dt


def _causal_conv(p: Params, xBC: torch.Tensor, carry: torch.Tensor = None,
                 carry_out: torch.Tensor = None) -> torch.Tensor:
    """Depthwise causal conv, bias and SiLU over [B,S,CH] in xBC's dtype
    (``kernels/causal_conv.py``: one kernel on the card); carry: [B,w-1,CH]
    history (zeros without).  The new window, the last w-1 positions of
    history + xBC, is written into ``carry_out`` in place where given."""
    return causal_conv(xBC, p["conv_w"], p["conv_b"], carry, carry_out)


def _split(cfg: ArchConfig, conv_out: torch.Tensor):
    d_in, H, P, N, G = ssm_dims(cfg)
    B, S, _ = conv_out.shape
    xh = conv_out[..., :d_in].reshape(B, S, H, P)
    Bm = conv_out[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = conv_out[..., d_in + G * N:].reshape(B, S, G, N)
    return xh, Bm, Cm


def ssm_block(p: Params, cfg: ArchConfig, x: torch.Tensor, cache=None, pos=None,
              mode: str = "full"):
    """Full mamba2 mixer.  mode: full (or train) | prefill | decode.

    prefill writes the conv window and the final state into ``cache``;
    decode reads and updates them; both in place.  Returns (out, cache)."""
    d_in, H, P, N, G = ssm_dims(cfg)
    B_ = x.shape[0]
    z, xBC, dt = _project(p, cfg, x)
    A = -torch.exp(p["A_log"])
    if mode == "decode":
        # one-token recurrence, as the reference (no kernel)
        conv_out = _causal_conv(p, xBC, cache["conv"], cache["conv"])
        xh, Bm, Cm = _split(cfg, conv_out)
        dA = torch.exp(dt[:, 0] * A)  # [B,H]
        rep = H // G
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1) if G != H else Bm[:, 0]  # [B,H,N]
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1) if G != H else Cm[:, 0]
        h = cache["ssd"].to(F32)
        h = h * dA[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", xh[:, 0].to(F32), Bh.to(F32), dt[:, 0])
        y = torch.einsum("bhn,bhpn->bhp", Ch.to(F32), h)
        y = y + p["Dskip"][None, :, None] * xh[:, 0].to(F32)
        y = y.reshape(B_, 1, d_in).to(x.dtype)
        cache["ssd"].copy_(h)
    else:
        S = x.shape[1]
        conv_out = _causal_conv(p, xBC, None, cache["conv"] if mode == "prefill" else None)
        xh, Bm, Cm = _split(cfg, conv_out)
        y, h_final = ssd_mixer(xh, dt, A, Bm, Cm, return_state=True)
        y = y.to(F32) + p["Dskip"][None, None, :, None] * xh.to(F32)
        y = y.reshape(B_, S, d_in).to(x.dtype)
        if mode == "prefill":
            cache["ssd"].copy_(h_final)

    # gated rmsnorm + output projection
    g = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * p["norm"].to(F32)
    return torch.einsum("bse,ed->bsd", g.to(x.dtype), p["wo"]), cache
