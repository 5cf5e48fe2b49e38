"""Share of the experts' rows that carry a token over the traced ticks (%):
the program's ``moe.kept`` over ``moe.rows`` counters, prefill and decode."""
from port_bench.metrics._spans import moe_fill


def read(record):
    return moe_fill("prefill", "decode")
