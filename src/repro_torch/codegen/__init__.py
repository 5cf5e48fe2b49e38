"""The paper's code-generation step, ported: plans (copied from the
reference), their validation, happens-before analysis and pseudo-C
rendering, and their execution on m CUDA streams of one card."""
from repro_torch.codegen.plan import (
    CommRound,
    ExecutionPlan,
    PlanSegment,
    RegisterLayout,
    Superstep,
    Transfer,
    WCETCertificate,
    build_plan,
    build_segments,
    coalesce_transfer_steps,
    migrate_registers,
    pack_registers,
    plan_fingerprint,
    plan_summary,
    wcet_certificate,
)
from repro_torch.codegen.validate import PlanValidationError, validate_plan
from repro_torch.codegen.analyze import AnalysisReport, PlanHazardError, analyze_plan
from repro_torch.codegen.executor import (
    MPMDExecutor,
    build_mpmd_executor,
    executed_comm_bytes,
    interpret_plan,
    plan_liveness,
)
from repro_torch.codegen.render import render_pseudo_c

__all__ = [
    "CommRound",
    "ExecutionPlan",
    "PlanSegment",
    "RegisterLayout",
    "Superstep",
    "Transfer",
    "WCETCertificate",
    "build_plan",
    "build_segments",
    "coalesce_transfer_steps",
    "migrate_registers",
    "pack_registers",
    "plan_fingerprint",
    "plan_summary",
    "wcet_certificate",
    "PlanValidationError",
    "validate_plan",
    "AnalysisReport",
    "PlanHazardError",
    "analyze_plan",
    "MPMDExecutor",
    "interpret_plan",
    "build_mpmd_executor",
    "executed_comm_bytes",
    "plan_liveness",
    "render_pseudo_c",
]
