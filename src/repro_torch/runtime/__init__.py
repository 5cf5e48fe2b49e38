"""The fault runner, the elastic planner and the port's spans and counters.

``spans`` loads with the package (the model and the engine record through
it); the runner's and the planner's names load on first use, so that the
model's modules do not pull in the plan machinery.
"""
import importlib

from repro_torch.runtime import spans

_HOME = {
    "ElasticPlan": "elastic",
    "ElasticPlanner": "elastic",
    "HealthMonitor": "elastic",
    "WorkerState": "elastic",
    "simulate_failure_recovery": "elastic",
    "FaultEvent": "faults",
    "FaultPlan": "faults",
    "RunOutcome": "faults",
    "run_with_faults": "faults",
    "resume_plan": "faults",
    "kill_and_resume_drill": "faults",
}

__all__ = [
    "ElasticPlan",
    "ElasticPlanner",
    "HealthMonitor",
    "WorkerState",
    "simulate_failure_recovery",
    "FaultEvent",
    "FaultPlan",
    "RunOutcome",
    "run_with_faults",
    "resume_plan",
    "kill_and_resume_drill",
]


def __getattr__(name):
    if name not in _HOME:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
