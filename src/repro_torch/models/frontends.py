"""Modality frontend stubs: precomputed frame or patch embeddings.

Port of ``repro/models/frontends.py``.  The ``[audio]`` (HuBERT) and
``[vlm]`` (LLaVA-NeXT) architectures specify the transformer backbone only;
the frontend supplies *precomputed* frame/patch embeddings, which
``forward`` takes as ``inputs["embeds"]`` ahead of any ``tokens``.  These
helpers give deterministic synthetic inputs with the right shapes and
dtypes, and the shapes the dry run needs as tensors on the ``meta`` device
(the port's counterpart of ``jax.ShapeDtypeStruct``: no allocation).

``VLM_IMAGE_TOKENS`` and :func:`frontend_token_split` are the reference's;
:func:`synth_inputs` draws from a ``torch.Generator``, so its values differ
from ``jax.random``'s (tests that compare the two packages feed both the
same numpy inputs).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["VLM_IMAGE_TOKENS", "frontend_token_split", "synth_inputs", "input_structs"]

# LLaVA-NeXT anyres: base 24x24 grid + up to 4 tiles -> we stub one image as
# a fixed 576-token row prepended to the text tokens.
VLM_IMAGE_TOKENS = 576


def frontend_token_split(cfg: ArchConfig, seq_len: int) -> Tuple[int, int]:
    """(n_embed_tokens, n_text_tokens) for a total sequence of ``seq_len``."""
    if cfg.frontend == "audio":
        return seq_len, 0               # encoder consumes frames only
    if cfg.frontend == "vlm":
        n_img = min(VLM_IMAGE_TOKENS, seq_len // 2)
        return n_img, seq_len - n_img
    return 0, seq_len


def synth_inputs(cfg: ArchConfig, batch: int, seq_len: int, generator: torch.Generator,
                 device: DeviceLike = "cuda") -> Dict[str, Optional[torch.Tensor]]:
    """Synthetic inputs drawn from ``generator`` (on its own device), placed
    on ``device``: ``embeds`` [batch, n_embed, d_model] bf16, normals at
    0.02 as in the reference, and ``tokens`` [batch, n_text] int32, uniform
    over the vocabulary; a part with no positions is left out."""
    dev = resolve_device(device)
    n_emb, n_txt = frontend_token_split(cfg, seq_len)
    out: Dict[str, Optional[torch.Tensor]] = {}
    if n_emb:
        draw = torch.randn((batch, n_emb, cfg.d_model), generator=generator,
                           device=generator.device)
        out["embeds"] = draw.mul_(0.02).to(device=dev, dtype=torch.bfloat16)
    if n_txt:
        out["tokens"] = torch.randint(0, cfg.vocab, (batch, n_txt), generator=generator,
                                      device=generator.device, dtype=torch.int32).to(dev)
    return out


def input_structs(cfg: ArchConfig, batch: int, seq_len: int) -> Dict[str, torch.Tensor]:
    """The inputs' shapes and dtypes as ``meta`` tensors (no allocation)."""
    n_emb, n_txt = frontend_token_split(cfg, seq_len)
    out = {}
    if n_emb:
        out["embeds"] = torch.empty((batch, n_emb, cfg.d_model), dtype=torch.bfloat16,
                                    device="meta")
    if n_txt:
        out["tokens"] = torch.empty((batch, n_txt), dtype=torch.int32, device="meta")
    return out
