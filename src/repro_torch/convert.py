"""Weights from the JAX reference's parameter tree, as numpy arrays.

``params_from_numpy(cfg, jax.tree.map(np.asarray, params))`` gives the port's
model with exactly the reference's weights, so that tests can run both
packages on the same numbers.  The reference stacks every layer's parameters
with a leading ``[L]`` dim under ``segments/<name>/p0`` (``dense`` or
``ssm``); they are unstacked here into the port's per-layer blocks.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Transformer, segment_name

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy -> torch, keeping the dtype, bfloat16 included (numpy knows it
    only through the reference's ``ml_dtypes``; its values pass through f32
    exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: jax arrays are read-only


@torch.no_grad()
def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device: DeviceLike = "cuda") -> Transformer:
    """Build the port's model from the reference's parameter tree (numpy
    leaves).  The model's dtype is the embedding's; every leaf must be
    present with the shape and dtype the port expects (the SSM's f32 leaves
    stay f32 in a bf16 model)."""
    dev = resolve_device(device)
    embed = tensor_from_numpy(tree["embed"])
    model = Transformer(cfg, device=dev, dtype=embed.dtype)
    stacked = tree["segments"][segment_name(cfg)]["p0"]
    for name, prm in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            layer, node = int(parts[1]), stacked
            for key in parts[2:]:
                node = node[key]
            value = tensor_from_numpy(np.asarray(node)[layer])
        else:
            node = tree
            for key in parts:
                node = node[key]
            value = tensor_from_numpy(node)
        if tuple(value.shape) != tuple(prm.shape) or value.dtype != prm.dtype:
            raise ValueError(f"{name}: reference {tuple(value.shape)} {value.dtype}, "
                             f"port {tuple(prm.shape)} {prm.dtype}")
        prm.copy_(value)
    return model
