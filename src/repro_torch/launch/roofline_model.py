"""Analytic roofline terms per (arch × shape × mesh) cell.

Port of ``repro/launch/roofline_model.py``: the reference's closed-form
per-component counts, copied formula for formula (``param_stats``,
``_ways``, ``_attn_layer``, ``_mlp_layer``, ``_moe_layer``, ``_ssm_layer``,
``_embed_loss``, ``analytic_terms``), so that its terms equal the
reference's for every cell.  Two changes:

- The chip is a parameter, a :class:`Chip` (peak FLOP/s, memory rate, link
  rate, memory size); :data:`H100` is the port's card, from NVIDIA's data
  sheet.  ``Terms.roofline(chip)`` and ``analytic_terms(..., chip=H100)``
  take it where the reference reads module constants of its TPU.
- The parameter trees are the port's ``models.transformer.model_defs``,
  walked by :func:`_leaves` in ``jax.tree_util``'s order (dict keys sorted
  at every level), so the sums run in the reference's order.

Conventions (the reference's): flops counted as 2·(multiply-adds); all
terms are **per device per step**; ``train`` multiplies fwd by 3 (bwd =
2×fwd) plus recompute for components whose outputs the remat policy does
not save (batched-dim dots: attention core, SSD core, MoE dispatch/experts
-> 4×).  The reference validates these formulas against XLA's counts of
unrolled probe lowerings; the port holds them against its own counted
steps (``launch/analysis.py::validate_probe``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.parallel.sharding import OPT_RULES, SERVE_RULES, TRAIN_RULES, ParamDef

__all__ = ["Chip", "H100", "Terms", "param_stats", "analytic_terms"]

BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class Chip:
    """One device's peaks: ``peak_flops`` (bf16, dense), ``hbm_bw``
    (bytes/s), ``link_bw`` (bytes/s between devices), ``hbm_bytes``, and
    ``f32_flops`` (f32 outside the tensor cores; default ``peak_flops``)."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float
    f32_flops: Optional[float] = None

    def bound_ms(self, flops: float, nbytes: float, dtype) -> Tuple[float, str]:
        """The least time of a kernel's work: (ms, ``"bytes"`` or
        ``"operations"``), the larger of its bytes over ``hbm_bw`` and its
        operations over the peak for ``dtype`` (``torch.bfloat16``:
        ``peak_flops``; ``torch.float32``: ``f32_flops``)."""
        peak = {"torch.bfloat16": self.peak_flops,
                "torch.float32": self.f32_flops or self.peak_flops}[str(dtype)]
        t_bytes = nbytes / self.hbm_bw * 1e3
        t_ops = flops / peak * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# NVIDIA H100 SXM5 80GB, data sheet (dense rates, no sparsity, at its 700 W
# limit): 989 TFLOP/s bf16 tensor core, 67 TFLOP/s f32 (non-tensor),
# 3.35 TB/s HBM3, 80 GB, NVLink 900 GB/s (the data sheet's one figure,
# both directions together)
H100 = Chip("NVIDIA H100 80GB HBM3", peak_flops=989e12, hbm_bw=3.35e12, link_bw=900e9,
            hbm_bytes=80e9, f32_flops=67e12)


@dataclasses.dataclass
class Terms:
    flops: float = 0.0            # per device
    bytes: float = 0.0            # per device (HBM traffic)
    coll: float = 0.0             # per device (ICI bytes)

    def add(self, flops=0.0, bytes=0.0, coll=0.0):
        self.flops += flops
        self.bytes += bytes
        self.coll += coll

    def roofline(self, chip: Chip = H100) -> Dict[str, float]:
        return {
            "compute_s": self.flops / chip.peak_flops,
            "memory_s": self.bytes / chip.hbm_bw,
            "collective_s": self.coll / chip.link_bw,
        }


def _leaves(defs, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], ParamDef]]:
    """(path, leaf) of a tree of nested dicts of :class:`ParamDef`, keys
    sorted at every level (``jax.tree_util``'s flattening order)."""
    if isinstance(defs, ParamDef):
        yield path, defs
        return
    for k in sorted(defs):
        yield from _leaves(defs[k], path + (k,))


def _ways(defs, rules, mesh_shape) -> Dict[str, Any]:
    """Per-tensor sharding way-counts split into model vs data axes."""
    out = {}
    for path, d in _leaves(defs):
        spec = d.pspec(rules, mesh_shape)
        wm = wd = 1
        for names in spec:
            if names is None:
                continue
            for nm in (names if isinstance(names, tuple) else (names,)):
                if nm == "model":
                    wm *= mesh_shape[nm]
                else:
                    wd *= mesh_shape[nm]
        key = "/".join(path)
        out[key] = (int(np.prod(d.shape)), wm, wd, d.dtype)
    return out


def param_stats(cfg: ArchConfig, rules, mesh_shape) -> Dict[str, float]:
    """(per-device shard bytes, per-device 'used' bytes, FSDP gather
    collective bytes per full param use).

    ``data``-axis sharding is FSDP (gathered at use) ONLY on the ``embed``
    logical dim; on TP dims (``expert_ffn``, serve-time ``ffn``, ``batch``)
    the weights stay sharded and the *activations* pay psums instead
    (charged in the per-layer terms)."""
    defs = T.model_defs(cfg)
    shard_b = use_b = gather_b = n_params = 0.0
    for _path, d in _leaves(defs):
        spec = d.pspec(rules, mesh_shape)
        wm = wd_fsdp = wd_tp = 1
        for ax_name, names in zip(d.axes, tuple(spec) + (None,) * 8):
            if names is None:
                continue
            for nm in (names if isinstance(names, tuple) else (names,)):
                if nm == "model":
                    wm *= mesh_shape[nm]
                elif ax_name == "embed":
                    wd_fsdp *= mesh_shape[nm]
                else:
                    wd_tp *= mesh_shape[nm]
        n = int(np.prod(d.shape))
        b = n * BF16
        n_params += n
        shard_b += b / (wm * wd_fsdp * wd_tp)
        use_b += b / (wm * wd_tp)       # FSDP dims gathered, TP dims stay
        if wd_fsdp > 1:
            gather_b += b / (wm * wd_tp)
    return {"n_params": n_params, "shard_bytes": shard_b,
            "use_bytes": use_b, "gather_bytes": gather_b}


# --------------------------------------------------------------------------- #
# per-component per-LAYER counts (global, fwd only, whole batch)
# --------------------------------------------------------------------------- #
def _attn_layer(cfg: ArchConfig, B: int, S: int, kind: str, t: Terms,
                n_dev: int, dp: int, tp: int, mult_proj: float, mult_core: float):
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if kind == "decode":
        tok, ctx = B, S
    else:
        # the chunked-jnp path (and the flash kernel's static grid) computes
        # ALL S^2 scores and masks — no causal flop discount
        tok, ctx = B * S, S
    if cfg.mla is not None:
        m = cfg.mla
        dq = m.nope_head_dim + m.rope_head_dim
        proj = 2 * tok * d * (H * dq + m.kv_lora_rank + m.rope_head_dim)
        proj += 2 * tok * m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
        proj += 2 * tok * H * m.v_head_dim * d
        core_d = m.kv_lora_rank + m.rope_head_dim if kind == "decode" \
            else (m.nope_head_dim + m.rope_head_dim + m.v_head_dim)
        core = 2 * 2 * tok * H * ctx * core_d
        cache_row = (m.kv_lora_rank + m.rope_head_dim) * BF16
    else:
        proj = 2 * tok * d * Dh * (2 * H + 2 * KV)
        core = 2 * 2 * tok * H * ctx * Dh
        cache_row = 2 * KV * Dh * BF16
    t.add(flops=(proj * mult_proj + core * mult_core) / n_dev)
    # bytes: activations in/out of each matmul (bf16) + score traffic (f32)
    act = tok * d * BF16 * 8
    score = tok * ctx * (H if cfg.mla is None else H) * F32 * 2 * mult_core / 2
    t.add(bytes=(act * mult_proj + score) / n_dev)
    if kind == "decode":
        # read the whole cache once per decode step
        t.add(bytes=B * S * cache_row / n_dev)
    # TP/psum: attention output partial-sum when context or head_dim sharded
    if tp > 1:
        t.add(coll=tok * d * BF16 * 2 * (mult_core / 2) / (n_dev / tp))


def _mlp_layer(cfg, B, S, kind, t, n_dev, f, mult):
    tok = B if kind == "decode" else B * S
    t.add(flops=2 * tok * cfg.d_model * f * 3 * mult / n_dev,
          bytes=tok * (cfg.d_model * 4 + f * 2) * BF16 * mult / 2 / n_dev)


def _moe_layer(cfg, B, S, kind, t, n_dev, dp, tp, mult, moe_impl):
    m = cfg.moe
    tok = B if kind == "decode" else B * S
    d, fe = cfg.d_model, m.d_ff_expert
    # router + experts (active)
    t.add(flops=2 * tok * d * m.n_experts * mult / n_dev)
    t.add(flops=2 * tok * d * fe * 3 * m.top_k * mult / n_dev)
    if m.n_shared:
        _mlp_layer(cfg, B, S, kind, t, n_dev, m.n_shared * fe, mult)
    if m.dense_residual:
        _mlp_layer(cfg, B, S, kind, t, n_dev, cfg.d_ff, mult)
    # dispatch/combine overhead
    if moe_impl == "einsum":
        chunk = min(m.router_chunk, tok)
        cap = max(1.0, m.top_k * chunk / m.n_experts * m.capacity_factor)
        disp = 2 * tok * m.n_experts * cap * d * 2          # dispatch+combine
        t.add(flops=disp * mult / n_dev,
              bytes=tok * m.top_k * m.n_experts * cap / chunk * F32 / n_dev)
    else:  # scatter: zero-FLOP dispatch, index traffic only
        t.add(bytes=tok * m.top_k * (d * BF16 * 2 + 8) / n_dev)
    # EP combine: expert outputs reduced across the model axis
    if tp > 1:
        t.add(coll=tok * d * BF16 * 2 * mult / 2 / (n_dev / tp))


def _ssm_layer(cfg, B, S, kind, t, n_dev, mult_proj, mult_core):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    H = d_in // s.head_dim
    P, N, G = s.head_dim, s.d_state, s.n_groups
    tok = B if kind == "decode" else B * S
    proj = 2 * tok * d * (2 * d_in + 2 * G * N + H) + 2 * tok * d_in * d
    conv = 2 * tok * s.conv_width * (d_in + 2 * G * N)
    if kind == "decode":
        core = tok * (2 * H * P * N * 2)          # state update + readout
    else:
        Q = s.chunk
        core = tok * (2 * Q * (G * N + H * P) + 4 * H * P * N)
    t.add(flops=(proj * mult_proj + (conv + core) * mult_core) / n_dev,
          bytes=tok * (d * 6 + d_in * 6) * BF16 / n_dev)
    if kind == "decode":
        t.add(bytes=B * H * P * N * F32 * 2 / n_dev)   # recurrent state r/w


def _embed_loss(cfg, B, S, kind, t, n_dev, dp, tp, train: bool):
    tok = B if kind == "decode" else B * S
    V, d = cfg.vocab, cfg.d_model
    mult = 3 if train else 1
    # vocab shards over `model` only when divisible (mamba2's 50280 and
    # hubert's 504 are not) — otherwise the lm_head runs vocab-replicated
    v_ways = tp if V % tp == 0 else 1
    ways = min(dp * v_ways, n_dev)
    t.add(flops=2 * tok * d * V * mult / ways,
          bytes=(tok * V * F32 * 2 + tok * d * BF16 * 2) * mult / 2 / ways)
    if train:
        t.add(flops=6 * tok * V / ways)            # softmax-CE
    if v_ways > 1:   # vocab-sharded logsumexp/max psums
        t.add(coll=tok * F32 * 4 * mult / (n_dev / tp))


# --------------------------------------------------------------------------- #
def analytic_terms(
    cfg: ArchConfig,
    shape: ShapeSpec,
    mesh_shape: Dict[str, int],
    moe_impl: str = "einsum",
    microbatches: Optional[int] = None,
    bf16_moments: Optional[bool] = None,
    chip: Chip = H100,
) -> Dict[str, object]:
    n_dev = int(np.prod(list(mesh_shape.values())))
    dp = mesh_shape.get("pod", 1) * mesh_shape.get("data", 1)
    tp = mesh_shape.get("model", 1)
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    train = kind == "train"
    rules = TRAIN_RULES if train else SERVE_RULES
    ps = param_stats(cfg, rules, mesh_shape)
    if microbatches is None:
        per_shard = max(B // dp, 1)
        microbatches = max(1, per_shard // (4 if cfg.d_model < 2048 else 1)) \
            if train else 1
    acc = microbatches
    big = cfg.param_count()[0] > 2e11
    bf16_m = bf16_moments if bf16_moments is not None else (big and train)

    t = Terms()
    # ---- per-layer components ---------------------------------------- #
    mult_proj = 3.0 if train else 1.0    # saved by remat policy
    mult_core = 4.0 if train else 1.0    # recomputed in bwd
    for i in range(cfg.n_layers):
        if cfg.family == "ssm" or (cfg.hybrid and not cfg.is_attn_layer(i)):
            _ssm_layer(cfg, B, S, kind, t, n_dev, mult_proj, mult_core)
        else:
            _attn_layer(cfg, B, S, kind, t, n_dev, dp, tp, mult_proj, mult_core)
        if cfg.is_moe_layer(i):
            _moe_layer(cfg, B, S, kind, t, n_dev, dp, tp, mult_core, moe_impl)
        elif cfg.d_ff > 0:
            _mlp_layer(cfg, B, S, kind, t, n_dev, cfg.d_ff, mult_proj)
    _embed_loss(cfg, B, S, kind, t, n_dev, dp, tp, train)

    # ---- parameter traffic + FSDP collectives ------------------------- #
    uses = (2 if train else 1) * acc       # fwd + bwd re-gather per microbatch
    t.add(bytes=ps["use_bytes"] * uses, coll=ps["gather_bytes"] * uses)
    if train:
        # grad reduce-scatter (f32) once per microbatch + optimizer pass
        t.add(coll=ps["shard_bytes"] * 2 * acc)     # f32 grads / bf16 params
        mom = 2 if bf16_m else 4
        t.add(flops=15 * ps["n_params"] / n_dev,
              bytes=ps["n_params"] / n_dev * (3 * mom + 4 + 2 * BF16 + 2))

    terms = t.roofline(chip)
    dominant = max(terms, key=terms.get)
    _total, active = cfg.param_count()
    tokens = B * (S if kind != "decode" else 1)
    model_flops = (6.0 if train else 2.0) * active * tokens
    ideal = model_flops / n_dev / chip.peak_flops
    bound = max(terms.values())
    return {
        "roofline": terms,
        "dominant": dominant,
        "flops_per_dev": t.flops,
        "bytes_per_dev": t.bytes,
        "coll_per_dev": t.coll,
        "model_flops_total": model_flops,
        "model_flops_per_dev": model_flops / n_dev,
        "useful_flops_ratio": (model_flops / n_dev) / t.flops if t.flops else None,
        "roofline_fraction": ideal / bound if bound else None,
        "step_time_bound_s": bound,
        "meta": {"microbatches": acc, "bf16_moments": bf16_m,
                 "moe_impl": moe_impl},
    }
