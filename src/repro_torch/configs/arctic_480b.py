"""Snowflake Arctic (480B) — 128-expert top-2 MoE + parallel dense residual."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,              # dense-residual branch width
    vocab=32000,
    rope_theta=10000.0,
    moe=MoESpec(
        n_experts=128,
        top_k=2,
        d_ff_expert=4864,
        n_shared=0,
        every=1,
        offset=0,
        dense_residual=True,
    ),
    source="hf:Snowflake/snowflake-arctic-base",
)
