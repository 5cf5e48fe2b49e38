"""Device ms a traced step in the loss's forward and backward (remat's
recompute included): the stream time of the program's ``train.forward``
and ``train.backward`` spans, by their CUDA events."""
from port_bench.metrics._spans import per_step_device_ms


def read(record):
    return per_step_device_ms("train.forward", "train.backward")
