"""The whole step's share of the card's bf16 peak over the window (%)."""
from port_bench.metrics._common import mfu as read  # noqa: F401
