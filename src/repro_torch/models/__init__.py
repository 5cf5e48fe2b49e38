from repro_torch.models.transformer import (
    Block,
    SSMBlock,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
)
from repro_torch.models.slicing import (
    SLICEABLE_OPS,
    Tiling,
    choose_slice_factors,
    model_tilings,
    search_slice_factors,
    slice_model,
    slicing_summary,
    tile_bounds,
    tiling_leaves,
    uniform_factors,
)

__all__ = ["Block", "SSMBlock", "Transformer", "decode_step", "forward", "init_cache",
           "init_params", "SLICEABLE_OPS", "Tiling", "choose_slice_factors", "model_tilings",
           "search_slice_factors", "slice_model", "slicing_summary", "tile_bounds",
           "tiling_leaves", "uniform_factors"]
