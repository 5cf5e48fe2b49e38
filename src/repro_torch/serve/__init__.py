from repro_torch.serve.engine import (
    Engine,
    Request,
    ServeConfig,
    make_decode_step,
    make_prefill_step,
)

__all__ = ["Engine", "Request", "ServeConfig", "make_decode_step", "make_prefill_step"]
