from repro_torch.serve.engine import (
    Engine,
    Request,
    ServeConfig,
    make_decode_step,
    make_prefill_step,
)
from repro_torch.serve.frontend import (
    Backpressure,
    ChaosCampaign,
    ChaosEvent,
    Frontend,
    FrontendConfig,
    ServeRequest,
)
from repro_torch.serve.trace import (
    TraceRequest,
    input_pool,
    percentile,
    poisson_trace,
    trace_summary,
)

__all__ = [
    "Engine", "Request", "ServeConfig", "make_decode_step", "make_prefill_step",
    "Backpressure", "ChaosCampaign", "ChaosEvent", "Frontend",
    "FrontendConfig", "ServeRequest",
    "TraceRequest", "input_pool", "percentile", "poisson_trace",
    "trace_summary",
]
