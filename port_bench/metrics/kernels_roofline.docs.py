"""The port's kernels' share of their roofline over the traced span (%)."""
from port_bench.metrics._common import kernels_roofline as read  # noqa: F401
