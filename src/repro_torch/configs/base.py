"""Architecture + input-shape configuration system.

Every assigned architecture is a frozen :class:`ArchConfig`; every input
shape is a :class:`ShapeSpec`.  ``runnable_cells`` applies the brief's skip
rules (encoder-only archs have no decode step; ``long_500k`` needs
sub-quadratic attention).  ``reduced()`` returns a tiny same-family config
for CPU smoke tests — the full configs are only ever lowered (dry-run),
never materialized.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = [
    "MoESpec",
    "MLASpec",
    "SSMSpec",
    "HybridSpec",
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared experts (deepseek) — always-on branches
    every: int = 1              # MoE layer period
    offset: int = 0             # first layer index that is MoE
    first_dense: int = 0        # leading dense layers (deepseek-v2: 1)
    dense_residual: bool = False  # parallel dense FFN branch (arctic)
    capacity_factor: float = 1.25
    router_chunk: int = 1024    # tokens per dispatch chunk (GShard einsum path)


@dataclasses.dataclass(frozen=True)
class MLASpec:
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None   # None: full-rank q projection (v2-lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridSpec:
    attn_period: int = 8        # jamba: one attention layer per 8
    attn_offset: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | audio | ssm | hybrid | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: Optional[float] = 1e6   # None: no rope (hubert frontend pos-embeds)
    causal: bool = True                 # False: encoder-only (hubert)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq: int = 32768
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: Optional[SSMSpec] = None
    hybrid: Optional[HybridSpec] = None
    frontend: Optional[str] = None      # None | audio | vlm  (stub embeddings)
    attn_chunk: int = 1024              # q-chunk for flash-style jnp attention
    source: str = ""                    # provenance note

    # ------------------------------------------------------------------ #
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid per the brief)."""
        return self.family in ("ssm", "hybrid")

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense:
            return False
        return (i - m.offset) % m.every == 0 if i >= m.offset else False

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.hybrid is None:
            return True
        return i % self.hybrid.attn_period == self.hybrid.attn_offset

    # ------------------------------------------------------------------ #
    def param_count(self) -> Tuple[float, float]:
        """(total, active-per-token) parameter counts, analytic."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        for i in range(self.n_layers):
            lt = la = 0.0
            # mixer
            if self.family == "ssm" or (self.hybrid and not self.is_attn_layer(i)):
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                lt += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)  # in_proj
                lt += d_in * d                                            # out_proj
                lt += s.conv_width * (d_in + 2 * s.n_groups * s.d_state)  # conv
                lt += 2 * n_h                                             # A, D
                la += lt
            else:
                if self.mla is not None:
                    m = self.mla
                    qd = m.nope_head_dim + m.rope_head_dim
                    a = d * (m.kv_lora_rank + m.rope_head_dim)            # kv down
                    a += m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    if m.q_lora_rank:
                        a += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qd
                    else:
                        a += d * self.n_heads * qd
                    a += self.n_heads * m.v_head_dim * d                  # o proj
                else:
                    a = d * self.head_dim * (self.n_heads + 2 * self.n_kv_heads)
                    a += self.n_heads * self.head_dim * d
                lt += a
                la += a
            # ffn / moe
            if self.is_moe_layer(i):
                mo = self.moe
                e1 = 3 * d * mo.d_ff_expert
                lt += mo.n_experts * e1 + mo.n_shared * e1 + d * mo.n_experts
                la += mo.top_k * e1 + mo.n_shared * e1 + d * mo.n_experts
                if mo.dense_residual:
                    lt += 3 * d * self.d_ff
                    la += 3 * d * self.d_ff
            else:
                lt += 3 * d * self.d_ff
                la += 3 * d * self.d_ff
            total += lt
            active += la
        return float(total), float(active)

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: Dict = dict(
            name=self.name + "-reduced",
            family=self.family,
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab=256,
            qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm,
            rope_theta=self.rope_theta,
            causal=self.causal,
            tie_embeddings=self.tie_embeddings,
            max_seq=128,
            frontend=self.frontend,
            attn_chunk=32,
            source="reduced",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=32,
                router_chunk=32,
                first_dense=min(self.moe.first_dense, 1),
            )
        if self.mla is not None:
            kw["mla"] = MLASpec(
                kv_lora_rank=32,
                q_lora_rank=None if self.mla.q_lora_rank is None else 32,
                rope_head_dim=8,
                nope_head_dim=16,
                v_head_dim=16,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMSpec(
                d_state=16, head_dim=16, expand=2,
                n_groups=1, conv_width=4, chunk=16,
            )
        if self.hybrid is not None:
            kw["hybrid"] = HybridSpec(attn_period=4, attn_offset=1)
            kw["n_layers"] = 4
        return ArchConfig(**kw)


# --------------------------------------------------------------------------- #
# input shapes (assigned set — identical for all 10 LM archs)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def runnable_cells(cfg: ArchConfig) -> Tuple[str, ...]:
    """Shapes this arch runs, applying the brief's skip rules."""
    out = ["train_4k", "prefill_32k"]
    if not cfg.encoder_only:
        out.append("decode_32k")
        if cfg.sub_quadratic:
            out.append("long_500k")
    return tuple(out)


def skip_reason(cfg: ArchConfig, shape: str) -> Optional[str]:
    if shape in runnable_cells(cfg):
        return None
    if cfg.encoder_only:
        return "encoder-only arch has no decode step"
    return "long_500k needs sub-quadratic attention (pure full-attention arch)"
