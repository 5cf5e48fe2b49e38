"""Device ms a traced step in the f32 gradient accumulation and the update
(the final cast, the global norm, the clip and AdamW): the stream time of
the program's ``train.accumulate`` and ``train.update`` spans."""
from port_bench.metrics._spans import per_step_device_ms


def read(record):
    return per_step_device_ms("train.accumulate", "train.update")
