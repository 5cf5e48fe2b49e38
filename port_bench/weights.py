"""Weights drawn from ``--seed`` on the device, in a few large calls.

:func:`leaf_shapes` lists every leaf of a configuration by the name the
port's ``Transformer`` gives it, with its shape and whether it is kept in
f32.  :func:`draw` fills one flat buffer of the model's dtype and one of
f32 from a ``torch.Generator`` on the device and carves the leaves out of
them as views (each starting on 256 bytes).  How each leaf is drawn comes
from the configuration file's ``init`` table, keyed ``<module>.<leaf>``.
The same weights go to the port (:func:`to_port`) and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from port_bench.archcfg import fan_in, layer_kinds, ssm_dims

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
F32_LEAVES = {"moe.router", "ssm.dt_bias", "ssm.A_log", "ssm.Dskip"}
ALIGN = 128  # elements: 256 bytes in bf16
DRAW_CHUNK = 1 << 30


def leaf_shapes(arch: Dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, init key) of every leaf, in the port's names."""
    d, V = arch["d_model"], arch["vocab"]
    out = {"embed": ((V, d), "embed"), "final_norm.scale": ((d,), "final_norm.scale")}
    if not arch.get("tie_embeddings", False):
        out["lm_head"] = ((d, V), "lm_head")
    for i, (mixer, ffn) in enumerate(layer_kinds(arch)):
        pre = f"layers.{i}."
        leaves = {"ln1.scale": (d,)}
        if mixer == "ssm":
            d_in, H, P, N, G = ssm_dims(arch)
            ch = d_in + 2 * G * N
            leaves.update({"ssm.wz": (d, d_in), "ssm.wx": (d, d_in), "ssm.wB": (d, G * N),
                           "ssm.wC": (d, G * N), "ssm.wdt": (d, H), "ssm.dt_bias": (H,),
                           "ssm.A_log": (H,), "ssm.Dskip": (H,),
                           "ssm.conv_w": (arch["ssm"]["conv_width"], ch), "ssm.conv_b": (ch,),
                           "ssm.norm": (d_in,), "ssm.wo": (d_in, d)})
        else:
            if arch.get("qkv_bias") or arch.get("qk_norm") or arch.get("mla"):
                raise ValueError("this weight table covers plain GQA attention only")
            H, KV, Dh = arch["n_heads"], arch["n_kv_heads"], arch["head_dim"]
            leaves.update({"attn.wq": (d, H, Dh), "attn.wk": (d, KV, Dh),
                           "attn.wv": (d, KV, Dh), "attn.wo": (H, Dh, d)})
        if ffn == "dense":
            f = arch["d_ff"]
            leaves.update({"ln2.scale": (d,), "mlp.wg": (d, f), "mlp.wu": (d, f),
                           "mlp.wd": (f, d)})
        elif ffn == "moe":
            m = arch["moe"]
            E, f = m["n_experts"], m["d_ff_expert"]
            if m.get("n_shared") or m.get("dense_residual"):
                raise ValueError("this weight table covers routed experts only")
            leaves.update({"ln2.scale": (d,), "moe.router": (d, E), "moe.wg": (E, d, f),
                           "moe.wu": (E, d, f), "moe.wd": (E, f, d)})
        out.update({pre + k: (s, k) for k, s in leaves.items()})
    return out


def _fill(view: torch.Tensor, rule, shape, gen: torch.Generator) -> None:
    """Apply one ``init`` rule to a leaf already holding N(0, 1) draws (the
    normal rules) or anything (the others)."""
    if rule == "ones":
        view.fill_(1.0)
    elif rule == "zeros":
        view.zero_()
    elif "normal" in rule:
        view.mul_(1.0 / math.sqrt(fan_in(shape, rule["normal"])))
    elif "std" in rule:
        view.mul_(rule["std"])
    elif "softplus_inv_log_uniform" in rule:
        # the inverse softplus of a step drawn log-uniformly in [lo, hi]
        lo, hi = rule["softplus_inv_log_uniform"]
        u = torch.rand(view.shape, generator=gen, device=view.device, dtype=torch.float32)
        dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
        view.copy_(dt + torch.log(-torch.expm1(-dt)))
    elif "log_of_uniform" in rule:
        lo, hi = rule["log_of_uniform"]
        u = torch.rand(view.shape, generator=gen, device=view.device, dtype=torch.float32)
        view.copy_(torch.log(lo + (hi - lo) * u))
    else:
        raise ValueError(f"unknown init rule {rule!r}")


@torch.no_grad()
def draw(conf: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``conf`` (a configuration file's contents) as a view of
    one of two flat buffers on ``device``, drawn from ``seed``."""
    arch, init = conf["arch"], conf["init"]
    dtype = DTYPES[conf["dtype"]]
    shapes = leaf_shapes(arch)
    gen = torch.Generator(device=device).manual_seed(seed)
    layout = {False: [], True: []}  # f32? -> [(name, offset, shape, rule)]
    size = {False: 0, True: 0}
    for name, (shape, key) in shapes.items():
        rule = init[key]
        f32 = key in F32_LEAVES
        layout[f32].append((name, size[f32], shape, rule))
        size[f32] += -(-math.prod(shape) // ALIGN) * ALIGN
    out = {}
    for f32, leaves in layout.items():
        buf = torch.empty(size[f32], dtype=torch.float32 if f32 else dtype, device=device)
        # N(0, 1) over the whole buffer in a few large calls, then each leaf
        # scaled (or overwritten) by its rule
        for a in range(0, size[f32], DRAW_CHUNK):
            buf[a:a + DRAW_CHUNK].normal_(generator=gen)
        for name, off, shape, rule in leaves:
            view = buf[off:off + math.prod(shape)].view(shape)
            _fill(view, rule, shape, gen)
            out[name] = view
    return out


def to_port(port_cfg, weights: Dict[str, torch.Tensor], dtype: torch.dtype):
    """The port's ``Transformer`` holding ``weights`` (shared, not copied)."""
    from torch import nn

    from repro_torch.models.transformer import Transformer

    model = Transformer(port_cfg, device="meta", dtype=dtype)
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"leaves differ: {sorted(set(params) ^ set(weights))[:8]}")
    for name, p in params.items():
        w = weights[name]
        if w.shape != p.shape or w.dtype != p.dtype:
            raise ValueError(f"{name}: {tuple(w.shape)} {w.dtype} vs {tuple(p.shape)} {p.dtype}")
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, nn.Parameter(w, requires_grad=False))
    return model
