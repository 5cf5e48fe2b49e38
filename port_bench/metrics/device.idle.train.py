"""Share of the traced span in which no operation ran on the device (%)."""
from port_bench.metrics._common import device_idle as read  # noqa: F401
