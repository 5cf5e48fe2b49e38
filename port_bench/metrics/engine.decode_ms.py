"""Host ms a traced tick in ``Engine.tick``'s decode (the model's step and
the tokens' readback): the program's ``engine.decode`` spans."""
from port_bench.metrics._spans import per_tick_ms


def read(record):
    return per_tick_ms("engine.decode")
