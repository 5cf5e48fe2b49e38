"""DeepSeek-V2-Lite (16B total / 2.4B active) — MLA + fine-grained MoE.

Assignment: 27L d_model=2048 16H d_ff=1408 vocab=102400, MoE 64e top-6,
MLA kv_lora=512, 2 shared experts.  (The assignment note "160 routed" matches
full DeepSeek-V2, not Lite; we follow the structured numbers: 64 routed.)
Layer 0 keeps the dense 10944-wide FFN per the HF reference config.
"""
from repro_torch.configs.base import ArchConfig, MLASpec, MoESpec

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,          # MLA: per-head kv reconstructed from the latent
    head_dim=128,
    d_ff=10944,             # dense FFN width (layer 0 only)
    vocab=102400,
    rope_theta=10000.0,
    mla=MLASpec(
        kv_lora_rank=512,
        q_lora_rank=None,   # V2-Lite has no q-lora
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoESpec(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        every=1,
        offset=1,
        first_dense=1,
    ),
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite",
)
