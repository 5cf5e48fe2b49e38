"""Jamba-v0.1 (52B) — Mamba+attention 1:7 interleave with 16-expert MoE.

Hardware adaptation (DESIGN §2): Jamba's Mamba-1 layers are implemented with
the chunked SSD (mamba2) formulation — the selective-scan recurrence maps to
MXU-friendly chunk matmuls on TPU; d_state=16 per the Jamba config.
"""
from repro_torch.configs.base import ArchConfig, HybridSpec, MoESpec, SSMSpec

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    rope_theta=None,        # jamba uses no positional encoding in attn layers
    hybrid=HybridSpec(attn_period=8, attn_offset=4),
    moe=MoESpec(
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        every=2,
        offset=1,
    ),
    ssm=SSMSpec(
        d_state=16,
        head_dim=64,
        expand=2,
        n_groups=1,
        conv_width=4,
        chunk=256,
    ),
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
)
