from repro_torch.models.transformer import (
    Block,
    Transformer,
    decode_step,
    forward,
    init_cache,
    init_params,
)

__all__ = ["Block", "Transformer", "decode_step", "forward", "init_cache", "init_params"]
