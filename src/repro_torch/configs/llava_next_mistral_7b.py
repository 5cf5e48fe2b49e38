"""LLaVA-NeXT (Mistral-7B backbone) — VLM with anyres tiling.

The vision tower + anyres tile projector are a STUB per the brief:
``input_specs()`` provides precomputed patch embeddings (one row of image
tokens prepended to the text tokens); the backbone is Mistral-7B.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=32000,
    rope_theta=1e6,
    frontend="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified tier)",
)
