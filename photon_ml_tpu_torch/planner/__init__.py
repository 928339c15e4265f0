"""The adaptive runtime planner (port of `photon_ml_tpu/planner/`).

A `Plan` replaces the runtime constants the port has (the Python Avro
route's chunk rows, the serving bucket ceiling and flush wait, the refresh
loop's batch rows and delta-fraction escape) with typed decisions that
carry their evidence, built from a persisted run profile or a startup
calibration. Precedence everywhere: an explicit `PHOTON_*` knob, then the
plan, then the default; with no plan installed (or PHOTON_PLAN=0) every
consulting site returns its default bit for bit. Every run records the
active plan as a `plan` block (contracts.PLAN_BLOCK_KEYS). See `plan.py`
and `rules.py`.
"""

from photon_ml_tpu_torch.planner.plan import (  # noqa: F401
    DEFAULTS,
    KNOB_FOR,
    Plan,
    PlanDecision,
    PlanTopologyError,
    apply_online_decision,
    current_plan,
    default_for,
    inactive_block,
    install_plan,
    plan_block,
    plan_suppressed,
    plan_suppression_active,
    planned_value,
    uninstall_plan,
)
from photon_ml_tpu_torch.planner.rules import (  # noqa: F401
    TOPOLOGY_MATCH_FIELDS,
    calibration_probe,
    check_topology,
    ensure_ambient_plan,
    owned_plan,
    plan_from_calibration,
    plan_from_profile,
    plan_mode,
)

__all__ = [
    "DEFAULTS",
    "KNOB_FOR",
    "Plan",
    "PlanDecision",
    "PlanTopologyError",
    "TOPOLOGY_MATCH_FIELDS",
    "apply_online_decision",
    "calibration_probe",
    "check_topology",
    "current_plan",
    "default_for",
    "ensure_ambient_plan",
    "inactive_block",
    "install_plan",
    "owned_plan",
    "plan_block",
    "plan_from_calibration",
    "plan_from_profile",
    "plan_mode",
    "plan_suppressed",
    "plan_suppression_active",
    "planned_value",
    "uninstall_plan",
]
