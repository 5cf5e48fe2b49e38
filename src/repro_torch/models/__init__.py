from repro_torch.models.transformer import (
    Block,
    SSMBlock,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
)

__all__ = ["Block", "SSMBlock", "Transformer", "decode_step", "forward", "init_cache",
           "init_params"]
