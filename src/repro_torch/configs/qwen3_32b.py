"""Qwen3-32B — dense GQA LM with qk_norm, no QKV bias [hf:Qwen/Qwen3-32B]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qkv_bias=False,
    qk_norm=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-32B (assignment: qk_norm, GQA)",
)
