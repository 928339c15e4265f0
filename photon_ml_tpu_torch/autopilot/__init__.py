"""Closed-loop autoscaling on one card (port of `photon_ml_tpu/autopilot/`).

A supervised control loop (`Autopilot`, the `photon-autopilot` thread)
reads live telemetry through a typed `SensorSnapshot` (per-tenant labelled
latency histograms, shard loads, two-tier promotions, device-memory
headroom), evaluates declarative `ControlRule`s (the memory ladder, shard
grow, hot-row rebalance, wait retune) and drives the serving actuators
under hysteresis, cooldowns, an action budget and one actuator mutex,
journaling every decision and rolling back and quarantining a rule whose
action breaks the post-action probe. See `sensors.py`, `rules.py`,
`loop.py`.
"""

from photon_ml_tpu_torch.autopilot.loop import OUTCOMES, Autopilot, AutopilotFailure  # noqa: F401
from photon_ml_tpu_torch.autopilot.rules import (  # noqa: F401
    ACTION_KINDS,
    Action,
    ControlRule,
    default_rules,
    hbm_demote_rule,
    hbm_restore_rule,
    rebalance_rule,
    retune_rule,
    shard_grow_rule,
)
from photon_ml_tpu_torch.autopilot.sensors import (  # noqa: F401
    CoordinateSensors,
    SensorSnapshot,
    TenantSensors,
    read_sensors,
)

__all__ = [
    "ACTION_KINDS",
    "Action",
    "Autopilot",
    "AutopilotFailure",
    "ControlRule",
    "CoordinateSensors",
    "OUTCOMES",
    "SensorSnapshot",
    "TenantSensors",
    "default_rules",
    "hbm_demote_rule",
    "hbm_restore_rule",
    "read_sensors",
    "rebalance_rule",
    "retune_rule",
    "shard_grow_rule",
]
