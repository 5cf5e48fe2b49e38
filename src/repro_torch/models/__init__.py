from repro_torch.models.frontends import (
    VLM_IMAGE_TOKENS,
    frontend_token_split,
    input_structs,
    synth_inputs,
)
from repro_torch.models.transformer import (
    Block,
    LayerSlot,
    SSMBlock,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
    layer_plan,
    segments,
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

__all__ = ["Block", "LayerSlot", "SSMBlock", "Transformer", "decode_step", "forward",
           "init_cache", "init_params", "layer_plan", "segments", "VLM_IMAGE_TOKENS",
           "frontend_token_split", "input_structs", "synth_inputs", "SLICEABLE_OPS", "Tiling",
           "choose_slice_factors", "model_tilings", "search_slice_factors", "slice_model",
           "slicing_summary", "tile_bounds", "tiling_leaves", "uniform_factors"]
