"""TinyLlama-1.1B — llama2-arch small GQA LM [arXiv:2401.02385; hf]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    qkv_bias=False,
    rope_theta=10000.0,
    source="arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B",
)
