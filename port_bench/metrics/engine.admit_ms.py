"""Host ms a traced tick in ``Engine.tick``'s admission (each prefill, its
first-token readback and its splice): the program's ``engine.admit`` spans."""
from port_bench.metrics._spans import per_tick_ms


def read(record):
    return per_tick_ms("engine.admit")
