"""A configuration file (``configs/<name>.json``) and what the benchmark derives from it.

The file's ``arch`` object holds the model's sizes under the port's
``ArchConfig`` field names (nested ``moe``, ``ssm``, ``hybrid`` groups).  The
benchmark reads the layer pattern and the parameter counts from it with its
own arithmetic, and builds the port's ``ArchConfig`` only to hand it to the
system under test (:func:`port_config`).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Tuple


def load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def layer_kinds(arch: Dict) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every layer in order: mixer ``attn`` or ``ssm``, ffn
    ``dense``, ``moe`` or ``none``."""
    out = []
    moe, hyb = arch.get("moe"), arch.get("hybrid")
    for i in range(arch["n_layers"]):
        if arch["family"] == "ssm":
            out.append(("ssm", "none"))
            continue
        if hyb is not None:
            mixer = "attn" if i % hyb["attn_period"] == hyb["attn_offset"] else "ssm"
        else:
            mixer = "attn"
        is_moe = (moe is not None and i >= moe.get("first_dense", 0) and i >= moe["offset"]
                  and (i - moe["offset"]) % moe["every"] == 0)
        out.append((mixer, "moe" if is_moe else "dense"))
    return out


def ssm_dims(arch: Dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim P, state N, groups G) of the SSM mixer."""
    s = arch["ssm"]
    d_in = s["expand"] * arch["d_model"]
    return d_in, d_in // s["head_dim"], s["head_dim"], s["d_state"], s["n_groups"]


def active_params(arch: Dict) -> float:
    """Parameters a token multiplies through, the LM head included and the
    embedding lookup not: mixers' projections, the dense FFNs, the top-k
    routed experts (and shared ones) and the router of every MoE layer."""
    d = arch["d_model"]
    total = float(d * arch["vocab"])  # the LM head (tied or not)
    for mixer, ffn in layer_kinds(arch):
        if mixer == "ssm":
            d_in, H, P, N, G = ssm_dims(arch)
            total += d * (2 * d_in + 2 * G * N + H) + d_in * d
        else:
            H, KV, Dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
            total += d * Dh * (H + 2 * KV) + H * Dh * d
        if ffn == "dense":
            total += 3 * d * arch["d_ff"]
        elif ffn == "moe":
            m = arch["moe"]
            e1 = 3 * d * m["d_ff_expert"]
            total += (m["top_k"] + m.get("n_shared", 0)) * e1 + d * m["n_experts"]
            if m.get("dense_residual"):
                total += 3 * d * arch["d_ff"]
    return total


def port_config(arch: Dict, name: str):
    """The port's ``ArchConfig`` for ``arch`` (imported here, never at module import)."""
    from repro_torch.configs.base import ArchConfig, HybridSpec, MoESpec, SSMSpec

    kw = {k: v for k, v in arch.items() if k not in ("moe", "ssm", "hybrid")}
    for key, spec in (("moe", MoESpec), ("ssm", SSMSpec), ("hybrid", HybridSpec)):
        if arch.get(key) is not None:
            kw[key] = spec(**arch[key])
    return ArchConfig(name=name, **kw)


def fan_in(shape: Tuple[int, ...], dims) -> int:
    return math.prod(shape[i] for i in dims)
