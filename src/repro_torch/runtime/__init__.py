from repro_torch.runtime.elastic import (
    ElasticPlan,
    ElasticPlanner,
    HealthMonitor,
    WorkerState,
    simulate_failure_recovery,
)
from repro_torch.runtime.faults import (
    FaultEvent,
    FaultPlan,
    RunOutcome,
    kill_and_resume_drill,
    resume_plan,
    run_with_faults,
)

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
