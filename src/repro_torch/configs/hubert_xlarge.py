"""HuBERT-XLarge — encoder-only audio transformer (w2v2 arch) [arXiv:2106.07447].

The modality frontend (conv feature extractor) is a STUB per the brief:
``input_specs()`` provides precomputed frame embeddings; the backbone is the
48-layer bidirectional transformer.  No rope — positions come from the
(stubbed) convolutional positional embedding added to the frame features.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    rope_theta=None,
    frontend="audio",
    source="arXiv:2106.07447 (unverified tier)",
)
