"""The typed runtime plan: decisions, precedence, and the ambient install.

Port of `photon_ml_tpu/planner/plan.py`. A `Plan` is a typed set of
`PlanDecision`s (name, chosen value, source, the evidence that chose it,
and the default it displaced), built by `planner.rules` from a persisted
run profile (`utils/telemetry.read_profile`) or a startup calibration,
installed process-ambient, and consulted by every site that would
otherwise hard-code the quantity:

    value = planner.planned_value("ingest_chunk_rows")

Precedence is the reference's: an explicitly set `PHOTON_*` knob wins over
the plan (recorded as `source: "knob"`), the plan wins over the built-in
default, and with no plan installed every site returns exactly the value it
returned before the planner existed.

The port plans the quantities it has: `ingest_chunk_rows` (the Python
Avro route's chunk, io/avro_data.py), `serving_max_batch` and
`serving_max_wait_ms` (the engine's bucket ceiling, the batcher's and the
registry's flush wait), `refresh_batch_rows` and
`refresh_max_delta_fraction` (cli/refresh.py, game/incremental.py). The
reference's `pack_routing`, `assembly_routing`, `sparse_layout`,
`prefetch_depth`, `scan_fusion_max`, `re_bucket_shapes`,
`bench_score_reps` and the precision ladder's `tier_*` have no counterpart
in the port (ROADMAP, Known differences); naming one raises.

Every fit and serving run records the active plan as a `plan` block
(contracts.PLAN_BLOCK_KEYS), and `install_plan` journals one
`plan_decision` event per decision.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from typing import Dict, Optional

from photon_ml_tpu_torch.contracts import PLAN_BLOCK_KEYS, PLAN_DECISION_KEYS
from photon_ml_tpu_torch.utils.knobs import KNOBS, get_knob, knob_is_set

logger = logging.getLogger(__name__)


class PlanTopologyError(ValueError):
    """A profile measured on different hardware must not plan this run: the
    refusal names the mismatching topology field."""


# The planned quantities without a knob and their built-in defaults: the
# values the consulting sites used before the planner existed.
DEFAULTS: Dict[str, object] = {
    # Serving: the bucket ceiling (the power-of-two ladder up to it) and the
    # micro-batcher's partial-batch flush wait.
    "serving_max_batch": 256,
    "serving_max_wait_ms": 2.0,
}

# Decision -> the PHOTON_* knob whose explicit setting overrides the plan
# (and whose registry default is the decision's fallback).
KNOB_FOR: Dict[str, str] = {
    "ingest_chunk_rows": "PHOTON_STREAM_CHUNK_ROWS",
    "refresh_batch_rows": "PHOTON_REFRESH_BATCH_ROWS",
    "refresh_max_delta_fraction": "PHOTON_REFRESH_MAX_DELTA_FRACTION",
}


def default_for(name: str) -> object:
    """The value a consulting site gets with no plan installed: the knob
    registry's default for knob-backed decisions, DEFAULTS otherwise."""
    knob = KNOB_FOR.get(name)
    if knob is not None:
        return KNOBS[knob].default
    if name not in DEFAULTS:
        raise KeyError(f"unknown planned quantity {name!r} (known: {sorted((*DEFAULTS, *KNOB_FOR))})")
    return DEFAULTS[name]


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One planned quantity: what was chosen, by what, from what."""

    decision: str
    value: object
    source: str  # "profile" | "calibration" | "knob" | "autopilot"
    evidence: Dict[str, object]
    fallback: object  # the default the chosen value displaced

    def as_dict(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k in PLAN_DECISION_KEYS}


@dataclasses.dataclass(frozen=True)
class Plan:
    """A typed runtime plan: the decision set plus its provenance. There is
    no per-plan value accessor: `planned_value` is the one precedence."""

    source: str  # "profile" | "calibration" | "autopilot"
    profile_path: Optional[str]
    topology: Dict[str, object]
    decisions: Dict[str, PlanDecision]

    def block(self) -> Dict[str, object]:
        """The `plan` block (contracts.PLAN_BLOCK_KEYS, in order)."""
        return dict(zip(PLAN_BLOCK_KEYS, (True, self.source, self.profile_path,
                                          [self.decisions[k].as_dict() for k in sorted(self.decisions)])))


def inactive_block() -> Dict[str, object]:
    """The `plan` block of an unplanned run."""
    return dict(zip(PLAN_BLOCK_KEYS, (False, "off", None, [])))


# One plan per process, installed by the drivers and the estimator and read
# by the consulting sites; the lock guards installs (a read is one load).
_LOCK = threading.Lock()
_ACTIVE: Optional[Plan] = None
# Suppression depth (plan_suppressed): above 0 every consult returns the
# built-in defaults and ensure_ambient_plan installs nothing.
_SUPPRESS = 0


@contextlib.contextmanager
def plan_suppressed():
    """A scope that runs the hand-tuned defaults: inside it planned_value
    ignores any installed plan (explicit per-quantity knobs still win),
    ensure_ambient_plan installs nothing and plan_block() reads inactive."""
    global _SUPPRESS
    with _LOCK:
        _SUPPRESS += 1
    try:
        yield
    finally:
        with _LOCK:
            _SUPPRESS -= 1


def plan_suppression_active() -> bool:
    return _SUPPRESS > 0


def _journal(d: PlanDecision) -> None:
    from photon_ml_tpu_torch.utils import telemetry

    telemetry.emit_event("plan_decision", decision=d.decision, value=d.value, source=d.source,
                         fallback=d.fallback)


def install_plan(plan: Plan) -> Plan:
    """Make `plan` the process-ambient plan and journal every decision."""
    global _ACTIVE
    with _LOCK:
        _ACTIVE = plan
    for name in sorted(plan.decisions):
        _journal(plan.decisions[name])
    logger.info("runtime plan installed (%s%s): %d decision(s)", plan.source,
                f" from {plan.profile_path}" if plan.profile_path else "", len(plan.decisions))
    return plan


def uninstall_plan() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def apply_online_decision(name: str, value: object, *,
                          evidence: Optional[Dict[str, object]] = None) -> Optional[PlanDecision]:
    """The autopilot's online re-plan of one quantity, with the startup
    precedence: an explicitly set knob pins it (None, nothing changes);
    otherwise the decision lands in the ambient plan (a minimal
    `source="autopilot"` plan when none is installed) and is journaled.
    A no-op under `plan_suppressed`. The returned decision's `fallback` is
    the value it displaced, which a rollback restores."""
    global _ACTIVE
    default_for(name)  # an unknown quantity raises
    knob = KNOB_FOR.get(name)
    if knob is not None and knob_is_set(knob):
        return None
    if plan_suppression_active():
        return None
    with _LOCK:
        plan = _ACTIVE
        prior = plan.decisions.get(name) if plan is not None else None
        fallback = prior.value if prior is not None else default_for(name)
        d = PlanDecision(decision=name, value=value, source="autopilot",
                         evidence=dict(evidence or {}), fallback=fallback)
        if plan is None:
            plan = Plan(source="autopilot", profile_path=None, topology={}, decisions={name: d})
        else:
            plan = dataclasses.replace(plan, decisions={**plan.decisions, name: d})
        _ACTIVE = plan
    _journal(d)
    return d


def current_plan() -> Optional[Plan]:
    return _ACTIVE


def plan_block(overrides: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """The active plan's block, or the inactive block. `overrides` (decision
    name -> the value a CLI flag set) re-sources those decisions as "knob":
    the block shows what the run ran with."""
    plan = current_plan()
    if plan is None or plan_suppression_active():
        return inactive_block()
    block = plan.block()
    if overrides:
        decisions = [dict(d) for d in block["decisions"]]
        for d in decisions:
            name = d.get("decision")
            if name in overrides:
                d["value"] = overrides[name]
                d["source"] = "knob"
                d["evidence"] = {**dict(d.get("evidence") or {}), "explicit_override": True}
        block["decisions"] = decisions
    return block


_UNSET = object()


def planned_value(name: str, *, default: object = _UNSET) -> object:
    """The one accessor the consulting sites call. Precedence: an explicitly
    set knob for the quantity, then the installed plan's decision, then the
    built-in default (`default` when given): with no plan installed, exactly
    the value before the planner existed."""
    knob = KNOB_FOR.get(name)
    if knob is not None and knob_is_set(knob):
        return get_knob(knob)
    if not plan_suppression_active():
        plan = current_plan()
        if plan is not None and name in plan.decisions:
            return plan.decisions[name].value
    if default is not _UNSET:
        return default
    return default_for(name)
