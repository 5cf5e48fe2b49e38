"""Weights from the JAX reference's parameter tree, as numpy arrays.

``params_from_numpy(cfg, jax.tree.map(np.asarray, params))`` gives the port's
model with exactly the reference's weights, so that tests can run both
packages on the same numbers.  The reference stacks each position j of a
segment's pattern with a leading ``[repeat]`` dim under
``segments/<name>/p<j>`` (``dense``, ``ssm``, or ``lead`` and ``moe``); they
are unstacked here into the port's per-layer blocks: layer i of a segment
with a pattern of length P is ``p<j>[k]`` with i = the segment's offset +
k·P + j (``Transformer.plan``).

The way back, :func:`reference_tree`, turns the port's tensors keyed by
parameter name (the weights, or AdamW's ``m``/``v``) into the reference's
nested tree, each layer's leaf stacked over its segment's repeats again;
:func:`named_from_tree` reads such a tree back by parameter name.  Both feed
the checkpoint format, which is the reference's: a checkpoint written by
either package restores in the other.

``cnn_params_from_numpy`` does the same for a ``CNNModel``'s weights
(``{layer: {"w", "b"}}``, HWIO conv and ``[in, out]`` dense weights, kept in
those layouts).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import LayerSlot, Transformer, layer_plan

__all__ = ["cnn_params_from_numpy", "named_from_tree", "params_from_numpy", "reference_tree",
           "tensor_from_numpy"]


def _tree_path(plan: List[LayerSlot], name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where the port's parameter ``name`` sits in the reference's tree: the
    path of keys and, for a layer's leaf, its index k in the stacked
    ``[repeat]`` dim (``layers.<i>.attn.wq`` is
    ``segments/<segment>/p<j>/attn/wq[k]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        slot = plan[int(parts[1])]
        return ("segments", slot.segment, f"p{slot.j}", *parts[2:]), slot.k
    return tuple(parts), None


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
    and the MoE router stay f32 in a bf16 model)."""
    dev = resolve_device(device)
    embed = tensor_from_numpy(tree["embed"])
    model = Transformer(cfg, device=dev, dtype=embed.dtype)
    for name, prm in model.named_parameters():
        path, k = _tree_path(model.plan, name)
        node = tree
        for key in path:
            node = node[key]
        value = tensor_from_numpy(node if k is None else np.asarray(node)[k])
        if tuple(value.shape) != tuple(prm.shape) or value.dtype != prm.dtype:
            raise ValueError(f"{name}: reference {tuple(value.shape)} {value.dtype}, "
                             f"port {tuple(prm.shape)} {prm.dtype}")
        prm.copy_(value)
    return model


def reference_tree(cfg: ArchConfig, named: Mapping[str, torch.Tensor],
                   device: DeviceLike = "cpu") -> Dict[str, Any]:
    """The port's tensors keyed by parameter name (a model's
    ``named_parameters()``, or AdamW's ``m``/``v`` over them) as the
    reference's nested tree, on ``device`` (``"meta"`` gives the shapes
    alone): ``embed``, ``final_norm/scale``, ``lm_head``, and
    ``segments/<name>/p<j>/...`` with each layer's leaf stacked over the
    segment's repeats (``[repeat, ...]``).  Leaves are detached; stacking
    happens on ``device``, so a tree for the host costs no device memory."""
    plan = layer_plan(cfg)
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[str, ...], Dict[int, torch.Tensor]] = {}

    def put(path, value):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    for name, t in named.items():
        path, k = _tree_path(plan, name)
        t = t.detach().to(device)
        if k is None:
            put(path, t)
        else:
            stacks.setdefault(path, {})[k] = t
    for path, per_k in stacks.items():
        put(path, torch.stack([per_k[k] for k in range(len(per_k))]))
    return tree


def named_from_tree(cfg: ArchConfig, tree: Mapping[str, Any]) -> Dict[str, Any]:
    """The reference's nested tree (tensors or numpy arrays) read back by the
    port's parameter names: each layer's leaf is the view ``[k]`` of its
    stacked leaf.  Every leaf the port's model has must be present."""
    plan = layer_plan(cfg)
    out = {}
    for name, _ in Transformer(cfg, device="meta").named_parameters():
        path, k = _tree_path(plan, name)
        node = tree
        for key in path:
            node = node[key]
        out[name] = node if k is None else node[k]
    return out


def cnn_params_from_numpy(params: Mapping[str, Mapping[str, Any]],
                          device: DeviceLike = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's ``CNNModel.init_params`` tree (numpy leaves) as the
    port's: the same layers, leaves and layouts, on ``device``."""
    dev = resolve_device(device)
    return {layer: {k: tensor_from_numpy(v, dev) for k, v in leaves.items()}
            for layer, leaves in params.items()}
