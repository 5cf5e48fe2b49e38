from repro_torch.parallel.sharding import (
    AxisRules,
    ParamDef,
    PartitionSpec,
    TRAIN_RULES,
    OPT_RULES,
    SERVE_RULES,
    logical_to_pspec,
    abstract_tree,
    tree_map_defs,
    tree_pspecs,
    mesh_axis_size,
)

__all__ = [
    "AxisRules",
    "ParamDef",
    "PartitionSpec",
    "TRAIN_RULES",
    "OPT_RULES",
    "SERVE_RULES",
    "logical_to_pspec",
    "abstract_tree",
    "tree_map_defs",
    "tree_pspecs",
    "mesh_axis_size",
]
