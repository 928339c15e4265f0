"""Plan construction: profile rules, calibration, the topology guard and
the env gate.

Port of `photon_ml_tpu/planner/rules.py`, for the quantities the port
plans (planner/plan.py). `plan_from_profile` turns a persisted run profile
(`utils/telemetry.read_profile`) into a Plan: a fit profile plans
`ingest_chunk_rows` from its ingest stages, a serve profile the bucket
ceiling from its p95 batch and the flush wait from its p50 latency, each
with the evidence that chose it and the default it displaced, by the
reference's rules and constants. Every planned quantity is bit-neutral: the
Python route's ingest is the same rows in any chunking, and a request
scores to the same bits in any bucket.

A profile measured on another topology refuses (`check_topology` names
the field); the topology compared is the run's device's
(`utils/telemetry.device_topology(device)`), so a profile written on the
CPU refuses on the card and the other way round.

`calibration_probe` is the cold start (PHOTON_PLAN=1 with no profile): the
host's parallelism, the run's device, and one 4 MB upload and one tiny
op's round trip timed on it (`torch.cuda.synchronize` on the card). The
reference swallows a failed probe; on the card the port's raises.
`ensure_ambient_plan` is the one gate the drivers and the estimator call:
an explicit `--profile` beats PHOTON_PLAN_PROFILE, PHOTON_PLAN=0 turns
planning off, a missing PHOTON_PLAN_PROFILE runs unplanned (the run can
write it), a missing `--profile` raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Mapping, Optional

from photon_ml_tpu_torch.planner.plan import (
    KNOB_FOR,
    Plan,
    PlanDecision,
    PlanTopologyError,
    current_plan,
    default_for,
    install_plan,
    plan_suppression_active,
    uninstall_plan,
)
from photon_ml_tpu_torch.utils.knobs import _FALSE, _TRUE, get_knob, knob_is_set

logger = logging.getLogger(__name__)

# Topology fields a profile must match before its measurements may plan
# this run (host_cpus varies across schedulers of one machine class).
TOPOLOGY_MATCH_FIELDS = ("platform", "device_count", "device_kind", "process_count")

# The reference's rule thresholds (not planned quantities).
_INGEST_SKEW = 4.0  # decode/assemble imbalance before the chunk size moves
_CHUNK_ROWS_MIN = 65_536
_CHUNK_ROWS_MAX = 1_048_576
_WAIT_FLOOR_MS = 0.5


def effective_host_parallelism() -> int:
    """Usable host cores: the scheduler's affinity mask, else os.cpu_count()."""
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except (AttributeError, OSError):  # not Linux
        return max(1, os.cpu_count() or 1)


def check_topology(profile_topology: Mapping[str, object],
                   current: Optional[Mapping[str, object]] = None, *, device=None) -> Dict[str, object]:
    """Refuse a profile measured on other hardware; returns the current
    topology (the run's `device`'s unless `current` is given)."""
    if current is None:
        from photon_ml_tpu_torch.utils.telemetry import device_topology

        current = device_topology(device)
    for field in TOPOLOGY_MATCH_FIELDS:
        have, want = current.get(field), profile_topology.get(field)
        if str(have) != str(want):
            raise PlanTopologyError(
                f"profile topology mismatch on {field!r}: the profile was measured with "
                f"{field}={want!r} but this run has {field}={have!r} — refusing to plan from "
                "another machine's cost model (re-profile on this topology, or run without a "
                "profile)")
    return dict(current)


def _decide(decisions: Dict[str, PlanDecision], name: str, value: object, source: str,
            evidence: Dict[str, object]) -> None:
    """Record one decision, with the knob's precedence applied here too, so
    the block shows `source: "knob"` as soon as an override is in play."""
    fallback = default_for(name)
    knob = KNOB_FOR.get(name)
    if knob is not None and knob_is_set(knob):
        value = get_knob(knob)
        source = "knob"
        evidence = {**evidence, "knob": knob}
    decisions[name] = PlanDecision(decision=name, value=value, source=source, evidence=evidence,
                                   fallback=fallback)


def plan_from_profile(profile: Mapping[str, object], profile_path: Optional[str] = None, *,
                      device=None) -> Plan:
    """A Plan from a run profile (fit or serve kind); a topology other than
    the run's `device`'s refuses."""
    topology = check_topology(profile["device_topology"], device=device)
    decisions: Dict[str, PlanDecision] = {}
    src = "profile"
    dispatch = dict(profile.get("dispatch") or {})

    if profile.get("kind") == "fit":
        # Ingest chunk rows: a heavy decode/assemble skew on a streamed
        # Python-route ingest means the chunk boundary is in the wrong place.
        # Bit-neutral, bounded both ways.
        ingest = dict(profile.get("ingest") or {})
        chunk_rows = int(default_for("ingest_chunk_rows"))
        decode_s = float(ingest.get("decode") or 0.0)
        assemble_s = float(ingest.get("assemble") or 0.0)
        if bool(ingest.get("streaming")) and min(decode_s, assemble_s) > 0:
            if decode_s > _INGEST_SKEW * assemble_s:
                chunk_rows //= 2  # decode-bound: smaller chunks overlap more
            elif assemble_s > _INGEST_SKEW * decode_s:
                chunk_rows *= 2  # assembly-bound: fewer chunk boundaries
        chunk_rows = min(max(chunk_rows, _CHUNK_ROWS_MIN), _CHUNK_ROWS_MAX)
        _decide(decisions, "ingest_chunk_rows", chunk_rows, src,
                {"decode_s": decode_s, "assemble_s": assemble_s,
                 "streaming": bool(ingest.get("streaming"))})
    else:  # serve profile
        serving = dict(profile.get("serving") or {})
        # The bucket ceiling: the p95 batch rounded up to a power of two,
        # floored at 8, bounded by the larger of the built-in ceiling and the
        # profiled run's; a saturated p95 (at the profiled ceiling) recovers
        # to that bound instead of pinning a shrink.
        observed_ceiling = int(dispatch.get("max_batch") or default_for("serving_max_batch"))
        hard_ceiling = int(default_for("serving_max_batch"))
        p95_batch = serving.get("batch_size_p95")
        if p95_batch is None:
            hist = (dict(profile.get("metrics") or {}).get("histograms") or {}).get("serving_batch_size")
            if hist:
                from photon_ml_tpu_torch.utils.telemetry import snapshot_quantile

                p95_batch = snapshot_quantile(hist, 0.95)
        upper = max(hard_ceiling, observed_ceiling)
        max_batch = observed_ceiling
        if p95_batch:
            if int(p95_batch) >= observed_ceiling:
                max_batch = upper
            else:
                b = 8
                while b < int(p95_batch):
                    b <<= 1
                max_batch = min(max(b, 8), upper)
        _decide(decisions, "serving_max_batch", max_batch, src,
                {"profile_max_batch": observed_ceiling, "batch_size_p95": p95_batch})
        # The flush wait: half the observed p50, clamped to [floor, the
        # larger of the built-in wait and the profiled one]; without a p50,
        # the profiled run's wait (0.0 included).
        profile_wait = dispatch.get("max_wait_ms")
        p50 = serving.get("p50_ms")
        if p50:
            upper_wait = max(float(default_for("serving_max_wait_ms")),
                             0.0 if profile_wait is None else float(profile_wait))
            wait = min(upper_wait, max(float(p50) / 2.0, _WAIT_FLOOR_MS))
        else:
            wait = float(default_for("serving_max_wait_ms") if profile_wait is None else profile_wait)
        _decide(decisions, "serving_max_wait_ms", wait, src,
                {"p50_ms": p50, "profile_max_wait_ms": dispatch.get("max_wait_ms")})

    return Plan(source="profile", profile_path=profile_path, topology=topology, decisions=decisions)


def calibration_probe(device=None) -> Dict[str, object]:
    """The cold-start measurement: the host's parallelism, the run's device,
    one 4 MB upload's rate and one tiny op's round trip on it. On the card
    a failed probe raises (there is no fallback)."""
    import numpy as np
    import torch

    from photon_ml_tpu_torch.utils.telemetry import device_topology

    dev = torch.device("cpu" if device is None else device)
    topo = device_topology(dev)
    probe: Dict[str, object] = {"host_parallelism": effective_host_parallelism(),
                                "platform": topo.get("platform"),
                                "device_count": topo.get("device_count")}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    buf = torch.from_numpy(np.zeros((1 << 20,), np.float32))  # 4 MB: small but past the caches
    if dev.type == "cuda":
        buf = buf.pin_memory()
    t0 = time.perf_counter()
    on_dev = buf.to(dev, non_blocking=True)
    sync()
    probe["upload_gb_per_s"] = round(buf.numel() * 4 / max(time.perf_counter() - t0, 1e-9) / 1e9, 3)
    one = torch.ones(8, device=dev)
    (one + 1.0).sum().item()  # first-use costs outside the sample
    t0 = time.perf_counter()
    (one + 1.0).sum().item()
    probe["dispatch_rtt_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
    del on_dev
    return probe


def plan_from_calibration(probe: Optional[Mapping[str, object]] = None, *, device=None) -> Plan:
    """Cold-start plan (PHOTON_PLAN=1, no profile): the rules a startup
    probe can feed. Of the port's quantities that is `ingest_chunk_rows`,
    kept at its default with the host's parallelism as evidence."""
    from photon_ml_tpu_torch.utils.telemetry import device_topology

    probe = dict(probe if probe is not None else calibration_probe(device))
    decisions: Dict[str, PlanDecision] = {}
    cores = int(probe.get("host_parallelism") or 1)
    _decide(decisions, "ingest_chunk_rows", int(default_for("ingest_chunk_rows")), "calibration",
            {"host_parallelism": cores})
    return Plan(source="calibration", profile_path=None, topology=device_topology(device),
                decisions=decisions)


def plan_mode() -> Optional[bool]:
    """PHOTON_PLAN: True forces (calibrate without a profile), False turns
    planning off, None plans only when a profile is supplied."""
    env = str(get_knob("PHOTON_PLAN")).strip().lower()
    if env in _TRUE:
        return True
    if env in _FALSE:
        return False
    return None


def ensure_ambient_plan(profile_path: Optional[str] = None, *, device=None) -> Optional[Plan]:
    """Install a plan if the configuration asks for one and none is
    installed; returns the active plan, or None when planning is off.
    `profile_path` (--profile) beats PHOTON_PLAN_PROFILE; PHOTON_PLAN=0
    turns everything off; a topology other than the run's `device`'s and a
    broken profile raise."""
    if plan_suppression_active():
        return None
    active = current_plan()
    if active is not None:
        return active
    mode = plan_mode()
    if mode is False:
        return None
    path = profile_path or str(get_knob("PHOTON_PLAN_PROFILE")).strip()
    if path and profile_path is None and not os.path.exists(path):
        # PHOTON_PLAN_PROFILE may name the file this run will write: run
        # unplanned. A --profile that does not exist raises (below).
        logger.info("PHOTON_PLAN_PROFILE=%s does not exist yet; running unplanned "
                    "(this run can write it for the next round)", path)
        path = ""
    if path:
        from photon_ml_tpu_torch.utils.telemetry import read_profile

        return install_plan(plan_from_profile(read_profile(path), path, device=device))
    if mode is True:
        probe = calibration_probe(device)
        logger.info("planner calibration: upload %.3f GB/s, dispatch round trip %.3f ms",
                    probe["upload_gb_per_s"], probe["dispatch_rtt_ms"])
        return install_plan(plan_from_calibration(probe, device=device))
    return None


@contextlib.contextmanager
def owned_plan(profile_path: Optional[str] = None, *, device=None) -> Iterator[Optional[Plan]]:
    """A driver's plan, with the reference's ownership: when no plan is
    installed, `ensure_ambient_plan(profile_path, device=)` runs on entry
    and whatever it installed is uninstalled on every exit path; a plan a
    caller installed stays, and `profile_path` is then ignored (logged)."""
    owned = current_plan() is None
    if not owned and profile_path:
        logger.warning("--profile %s ignored: a runtime plan is already installed by the caller "
                       "(uninstall it to let this run plan itself)", profile_path)
    try:
        yield ensure_ambient_plan(profile_path, device=device) if owned else current_plan()
    finally:
        if owned:
            uninstall_plan()
