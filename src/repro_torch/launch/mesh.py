"""Mesh shapes of the dry run (port of ``repro/launch/mesh.py``).

The reference's ``make_production_mesh`` builds a ``jax.sharding.Mesh`` of
256 or 512 devices.  It has no counterpart here: torch has no device mesh
of 512 devices on one card.  The port works with mesh *shapes* (axis name
to size), which is all the sharding rules, the partition specs and the
analytic roofline read: :func:`production_mesh_shape` gives the reference's
two production shapes and :data:`CARD_MESH` the one card, on which every
tensor of a cell lives whole.
"""
from __future__ import annotations

from typing import Dict, Mapping

__all__ = ["CARD_MESH", "production_mesh_shape", "mesh_shape_dict", "mesh_name"]

CARD_MESH: Dict[str, int] = {"data": 1, "model": 1}


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """The reference's production mesh: 16 x 16 (``data``, ``model``), or
    2 x 16 x 16 (``pod``, ``data``, ``model``) across two pods."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def mesh_shape_dict(shape: Mapping[str, int]) -> Dict[str, int]:
    """A mesh shape as a plain dict, axis name to size, in its axes' order
    (the reference's takes a ``Mesh``; the port has only shapes)."""
    return {str(k): int(v) for k, v in shape.items()}


def mesh_name(shape: Mapping[str, int]) -> str:
    """``"16x16"``: the sizes in axis order, as the reference's artifacts
    name a mesh."""
    return "x".join(str(v) for v in shape.values())
