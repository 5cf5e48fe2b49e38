"""Host ms a traced tick spent waiting on the device for tokens: the
program's ``engine.first_token`` (each prefill's argmax) and
``engine.readback`` (the decode's ``tolist``) spans."""
from port_bench.metrics._spans import per_tick_ms


def read(record):
    return per_tick_ms("engine.first_token", "engine.readback")
