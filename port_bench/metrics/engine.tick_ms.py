"""Mean host wall of ``Engine.tick()`` over the window's untraced ticks (ms)."""


def read(record):
    ticks = record.readings.get("tick_ms")
    return sum(ticks) / len(ticks) if ticks else None
