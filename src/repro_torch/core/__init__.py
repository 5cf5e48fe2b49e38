"""Core of the reproduction: the paper's DAG-scheduling contribution."""
from repro_torch.core.graph import DAG, GraphError, density, random_dag
from repro_torch.core.costmodel import (
    HardwareSpec,
    OpCost,
    TPU_V5E,
    annotate,
    roofline_time,
)
from repro_torch.core.schedule import (
    Instance,
    Schedule,
    ScheduleError,
    remove_redundant_duplicates,
    single_worker_schedule,
    speedup,
    validate,
)
from repro_torch.core.list_scheduling import dsh, ish, list_schedule
from repro_torch.core.exact import SolverResult, branch_and_bound, tighten_schedule

__all__ = [
    "DAG",
    "GraphError",
    "density",
    "random_dag",
    "HardwareSpec",
    "OpCost",
    "TPU_V5E",
    "annotate",
    "roofline_time",
    "Instance",
    "Schedule",
    "ScheduleError",
    "remove_redundant_duplicates",
    "single_worker_schedule",
    "speedup",
    "validate",
    "dsh",
    "ish",
    "list_schedule",
    "SolverResult",
    "branch_and_bound",
    "tighten_schedule",
]
