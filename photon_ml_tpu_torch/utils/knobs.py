"""The PHOTON_* environment knobs the port reads.

Port of the part of `photon_ml_tpu/utils/knobs.py` that the serving tier
and its platform layers read: the same names, types, defaults and lenient
parsing (empty or unset means the default; a malformed value logs a
warning and reads as the default). `get_knob` on a name not registered here
raises, so a knob cannot be read without landing in this table.

`PHOTON_SERVING_HOT_ROWS` stages each random effect in the two-tier store
(`serving.bundle.load_bundle`), `PHOTON_SERVING_ENTITY_SHARD` row-sharded
over every card of the process (`serving.bundle.serving_entity_mesh`), and
`PHOTON_COLLECTIVE_RETRIES` bounds the re-dispatch of a host-dispatched
gather over those cards (`parallel.mesh.dispatch_collective`). The multi-tenant registry's (`PHOTON_TENANT_MAX_PENDING`,
`PHOTON_TENANT_HBM_FRACTION`) and the shadow controller's
(`PHOTON_SHADOW_*`) are the reference's, and so are the precision
ladder's (`PHOTON_TIER_*`). The solver's and the sweep executor's knobs (`PHOTON_SOLVE_RETRIES`, `PHOTON_SWEEP_*`) are the
reference's; `PHOTON_SWEEP_SCAN` is not registered, because the port has no
scan-dispatched bucket sweep. The multi-host supervisor's
(`PHOTON_HOST_HEARTBEAT_MS`, `PHOTON_HOST_LOSS_RETRIES`) are the
reference's too. `PHOTON_PIPELINE` is the reference's host-overlap switch,
read by `pipeline_enabled`; in the port it gates the staged checkpoint
write (game/coordinate_descent.py), the only host overlap the port has.
The refresh knobs (`PHOTON_REFRESH_BATCH_ROWS`,
`PHOTON_REFRESH_MAX_DELTA_FRACTION`) and `PHOTON_STREAM_CHUNK_ROWS` are
the reference's planned quantities' knobs: their sites read them through
`planner.planned_value` (knob > plan > default). The planner's
(`PHOTON_PLAN`, `PHOTON_PLAN_PROFILE`), the autopilot's
(`PHOTON_AUTOPILOT_*`) and the one-card reshard's
(`PHOTON_RESHARD_RETRIES`, `PHOTON_REBALANCE_MIN_PROMOTIONS`) are the
reference's too.
`PHOTON_SPARSE_LAYOUT`, `PHOTON_DEVICE_PACK`, `PHOTON_DEVICE_ASSEMBLY` and
`PHOTON_HOST_THREADS` are not registered: the port has none of the
quantities they set.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Tuple, Union

logger = logging.getLogger(__name__)

Value = Union[str, int, float, bool]

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@dataclasses.dataclass(frozen=True)
class Knob:
    name: str
    type: type
    default: Value
    doc: str
    choices: Optional[Tuple[str, ...]] = None  # str knobs: the legal values

    def parse(self, raw: str) -> Value:
        raw = raw.strip()
        if raw == "":
            return self.default
        if self.type is bool:
            low = raw.lower()
            if low in _TRUE:
                return True
            if low in _FALSE:
                return False
            logger.warning("%s=%r: expected one of %s; using default %r", self.name, raw,
                           "/".join((*_TRUE, *_FALSE)), self.default)
            return self.default
        if self.type in (int, float):
            try:
                return self.type(raw)
            except ValueError:
                logger.warning("ignoring malformed %s=%r (default %r)", self.name, raw, self.default)
                return self.default
        value = raw.lower() if self.choices is not None else raw
        if self.choices is not None and value not in self.choices:
            logger.warning("%s=%r: expected one of %s; using default %r", self.name, raw,
                           sorted(self.choices), self.default)
            return self.default
        return value


KNOBS: Dict[str, Knob] = {}


def _register(name: str, type_: type, default: Value, doc: str,
              choices: Optional[Tuple[str, ...]] = None) -> None:
    if name in KNOBS:
        raise ValueError(f"duplicate knob registration: {name!r}")
    if not isinstance(default, type_):
        raise TypeError(f"{name}: default {default!r} is not {type_.__name__}")
    KNOBS[name] = Knob(name, type_, default, doc, choices)


_register("PHOTON_FAULTS", str, "",
          'Deterministic fault-injection plan, e.g. "lookup:1,score@3,admit:p0.25" '
          "(see utils/faults.py).")
_register("PHOTON_FAULTS_SEED", int, 0,
          "Seed for probabilistic fault sites (site:pX): reproducible chaos schedules.")
_register("PHOTON_RETRY_MAX_ATTEMPTS", int, 3,
          "Bounded-backoff retry attempts for transient failures (min 1).")
_register("PHOTON_RETRY_BASE_DELAY_S", float, 0.05,
          "Retry backoff base delay in seconds (doubles per attempt).")
_register("PHOTON_RETRY_MAX_DELAY_S", float, 2.0, "Retry backoff delay cap in seconds.")
_register("PHOTON_WATCHDOG_MS", int, 0,
          "Hang-watchdog deadline (ms) armed around serving device dispatches; an "
          "over-deadline dispatch raises a typed DeviceHang. 0 = off.")
_register("PHOTON_SHARD_UPLOAD_RETRIES", int, 2,
          "Extra attempts a failed per-shard serving staging/restage gets before the "
          "failure surfaces (hot-swap rollback / shard stays degraded).")
_register("PHOTON_SERVING_ENTITY_SHARD", bool, False,
          "Stage serving RE matrices row-sharded over all local devices "
          "(no-op with one device).")
_register("PHOTON_COLLECTIVE_RETRIES", int, 1,
          "Extra re-dispatches a failed mesh collective program gets before "
          "the sweep degrades to the bitwise-equal per-bucket loop.")
_register("PHOTON_SERVING_HOT_ROWS", int, 0,
          "Two-tier serving store hot-set size (rows of each random effect kept on the "
          "device, the full matrix in host RAM); 0 = single-tier.")
_register("PHOTON_TENANT_MAX_PENDING", int, 64,
          "Default per-tenant admission quota in the multi-tenant registry (bounded pending "
          "requests per tenant; submits past it shed with a typed Overloaded naming the tenant).")
_register("PHOTON_TENANT_HBM_FRACTION", float, 1.0,
          "Fraction of the device-memory budget the multi-tenant fleet may pin; admission past it "
          "demotes the coldest READY tenant's RE rows to the host tier (never fails the tenant) "
          "before refusing.")
_register("PHOTON_SHADOW_MIN_WINDOWS", int, 3,
          "Shadow deployment (serving/shadow): consecutive evaluation windows that must agree "
          "before a verdict fires; all healthy promotes, all regressed rejects, a mixed run holds.")
_register("PHOTON_SHADOW_REGRESSION_TOL", float, 0.02,
          "Shadow deployment: a window is regressed when the challenger's primary metric is worse "
          "than the champion's by more than this (direction-aware: AUC down or RMSE up).")
_register("PHOTON_SHADOW_COOLDOWN_S", float, 0.0,
          "Shadow deployment: minimum seconds between shadow start and a verdict; 0 disables "
          "the cooldown.")
_register("PHOTON_SHADOW_MIRROR_FRACTION", float, 1.0,
          "Shadow deployment: fraction of champion traffic mirrored to the challenger tenant "
          "(deterministic credit accumulator, no RNG); 1.0 mirrors everything.")
_register("PHOTON_SERVING_HBM_BUDGET_BYTES", int, 0,
          "Device-memory budget a bundle hot-swap must fit in; 0 = the card's total "
          "memory (no check on the CPU).")
_register("PHOTON_TIER_LADDER", bool, False,
          "Precision-tier graceful degradation: 1 makes the HBM pressure valve "
          "and the autopilot's hbm-demote rule walk the f32 -> bf16 -> int8 -> "
          "host ladder (quantize-in-place before host-tier demotion); 0 "
          "(default) keeps the all-or-nothing host demotion and the bitwise "
          "serving contract. Opt-in because a "
          "quantized tenant answers under a CHARACTERIZED tolerance "
          "(contracts.TIER_TOLERANCES), not bitwise.")
_register("PHOTON_TIER_BF16_PRESSURE", float, 0.85,
          "Precision ladder: HBM pressure (pinned bytes / fleet budget) above "
          "which the autopilot's ladder-aware hbm-demote rule quantizes the "
          "coldest f32 tenant's RE rows to bf16 (the first, cheapest rung).")
_register("PHOTON_TIER_INT8_PRESSURE", float, 0.92,
          "Precision ladder: HBM pressure above which a bf16 tenant steps down "
          "to int8 rows (per-row symmetric scales); past int8 the only rung "
          "left is the host tier. Must be >= PHOTON_TIER_BF16_PRESSURE "
          "for the ladder to walk in order.")
_register("PHOTON_TIER_INT8_ERROR_CEILING", float, 0.1,
          "Precision ladder: refuse an int8 quantization whose measured worst "
          "per-coordinate relative round-trip error exceeds this ceiling — the "
          "tenant stays at bf16 and pressure relief falls through to the host "
          "tier instead of serving answers outside the characterized "
          "tolerance.")
_register("PHOTON_SWEEP_TRIAL_STACK", str, "",
          "Trial-stacked hyperparameter sweep evaluation (hyperparameter/sweep.py: k "
          "reg-weight trials in chunks over resident data, one host fetch a chunk): 1 "
          "forces, 0 disables (shard-group or serial evaluation instead); empty = auto (on "
          "when no coordinate's store is entity-sharded).",
          choices=("", *_TRUE, *_FALSE))
_register("PHOTON_SWEEP_MAX_STACK", int, 8,
          "Trials per stacked sweep chunk; larger candidate batches split into chunks of at "
          "most this many.")
_register("PHOTON_SWEEP_SHARD_GROUPS", int, 0,
          "Trial groups the cards partition into for shard-group sweep scheduling (one "
          "concurrent trial per group); 0 = auto (one group per card).")
_register("PHOTON_SOLVE_RETRIES", int, 1,
          "Extra solve attempts the divergence guard grants a non-finite coordinate update "
          "before keeping last-good.")
_register("PHOTON_HOST_HEARTBEAT_MS", int, 500,
          "Host-liveness heartbeat period (ms) in multi-host mode; a peer whose beat counter "
          "stalls for hostmesh.MISS_THRESHOLD (20) consecutive periods is declared lost (typed "
          "HostLoss, supervisor relaunch on the survivor set). Lower the period, not the "
          "threshold, for faster detection.")
_register("PHOTON_HOST_LOSS_RETRIES", int, 1,
          "Whole-host losses a multi-host supervisor absorbs before giving up (each costs one "
          "relaunch on the survivor set and one repeated sweep).")
_register("PHOTON_PIPELINE", str, "",
          "Host data-plane overlap: 1 forces threaded decode/pack/upload overlap, "
          "0 forces synchronous; empty = auto (on when >1 effective core).",
          choices=("", *_TRUE, *_FALSE))
_register("PHOTON_REFRESH_BATCH_ROWS", int, 4096,
          "Continuous-refresh loop (cli/refresh): target rows per streamed delta batch before "
          "triggering an incremental fit + delta swap; smaller batches trade solve efficiency for "
          "data->served freshness.")
_register("PHOTON_REFRESH_MAX_DELTA_FRACTION", float, 0.5,
          "Incremental fit escape hatch (game/incremental.py): when a delta batch churns more than "
          "this fraction of the merged dataset's rows, the delta path forces a warm-started FULL "
          "refit — past that point re-solving per changed entity costs more than one fused solve.")
_register("PHOTON_STREAM_CHUNK_ROWS", int, 262_144,
          "Rows per streamed ingest chunk on the pure-Python codec path (bounds decoded-record "
          "residency); the native path chunks per container file.")
_register("PHOTON_RESHARD_RETRIES", int, 2,
          "Extra attempts a failed per-shard upload gets during a live reshard or rebalance "
          "before the whole change rolls back to the old generation.")
_register("PHOTON_REBALANCE_MIN_PROMOTIONS", int, 2,
          "Observed two-tier promotions a coefficient row needs before a hot-row rebalance plan "
          "counts it as hot (serving/reshard.py).")
_register("PHOTON_AUTOPILOT_MS", int, 500,
          "Closed-loop autoscaling (photon_ml_tpu_torch/autopilot/): control-loop tick period in "
          "milliseconds; each tick snapshots the sensors and evaluates every armed ControlRule "
          "against fresh evidence.")
_register("PHOTON_AUTOPILOT_MAX_ACTIONS", int, 4,
          "Autopilot: bounded-actions budget, the most actuations the controller may apply within "
          "one cooldown window; rules that fire past the budget are journaled as suppressed, never "
          "applied.")
_register("PHOTON_AUTOPILOT_COOLDOWN_S", float, 2.0,
          "Autopilot: per-rule cooldown, the minimum seconds between two actuations of the same "
          "rule (and the width of the global action-budget window), so the loop settles between "
          "interventions instead of oscillating; 0 disables the cooldown.")
_register("PHOTON_PLAN", str, "",
          "Adaptive runtime planner (photon_ml_tpu_torch/planner/): 1 forces planning (from "
          "PHOTON_PLAN_PROFILE, else a fast startup calibration), 0 disables it entirely; empty = "
          "auto (plan only when a profile is supplied). Explicit PHOTON_* knobs always override "
          "plan decisions.",
          choices=("", *_TRUE, *_FALSE))
_register("PHOTON_PLAN_PROFILE", str, "",
          "Path to a persisted run profile (telemetry.write_profile / cli --profile) the planner "
          "consumes; a profile from a mismatched device topology refuses loudly naming the field.")
_register("PHOTON_TRACE", bool, False,
          "Span tracing (utils/telemetry.py): 1 records spans and exports Chrome "
          "trace-event JSON from cli.serve; 0 keeps span() a no-op.")


def _knob(name: str) -> Knob:
    knob = KNOBS.get(name)
    if knob is None:
        raise KeyError(f"unregistered knob {name!r} (the port reads {len(KNOBS)} knobs)")
    return knob


def get_knob(name: str, raw: Optional[str] = None) -> Value:
    """Knob `name` from the environment (or parsed from `raw`), typed."""
    knob = _knob(name)
    return knob.parse(os.environ.get(name, "") if raw is None else raw)


def knob_is_set(name: str) -> bool:
    """True when the knob is set to a non-empty value in the environment."""
    _knob(name)
    return os.environ.get(name, "").strip() != ""


def pipeline_enabled(override: Optional[bool] = None) -> bool:
    """Whether host work overlaps on threads: an explicit `override` (the
    estimator's `pipeline=`) wins, then PHOTON_PIPELINE (0/false/off/no
    disables, 1/true/on/yes forces), else on when this process may run on
    more than one core (a second thread on one core only contends)."""
    if override is not None:
        return bool(override)
    env = str(get_knob("PHOTON_PIPELINE")).strip().lower()
    if env in _FALSE:
        return False
    if env in _TRUE:
        return True
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # not Linux
        cores = os.cpu_count() or 1
    return cores > 1
