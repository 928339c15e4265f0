"""The autopilot's typed sensor surface.

Port of `photon_ml_tpu/autopilot/sensors.py`. `read_sensors` distills what
the control rules may see into one immutable `SensorSnapshot`: per-tenant
latency quantiles from the labelled telemetry histograms, per-shard request
loads from each coordinate's ShardHealth, two-tier promotions from each
store's promotion stats, the device bytes the fleet pins against its
budget for the registry's device, and the aggregate queue-wait and batch
quantiles the retune rule reads.

Snapshots are cumulative: loads, promotions and request counts only grow,
and the loop hands each rule the previous snapshot beside the current one,
so rules work on deltas. A rule handed `prev=None` (the first tick) must
not fire. Each tenant's `tier` (its precision rung) and `can_quantize`
(whether a ladder step down may pick it) are what the ladder-aware
hbm-demote and hbm-restore rules read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from photon_ml_tpu_torch.utils import telemetry

__all__ = ["CoordinateSensors", "TenantSensors", "SensorSnapshot", "read_sensors"]


@dataclasses.dataclass(frozen=True)
class CoordinateSensors:
    """One random-effect coordinate's placement and load."""

    cid: str
    n_shards: int
    sharded: bool  # row-sharded over the cards of a mesh
    two_tier: bool  # in a TwoTierEntityStore
    shard_loads: Tuple[int, ...]  # cumulative per-shard request rows
    promotions: int  # cumulative cold -> hot promotions (two-tier only)
    device_bytes: int

    @property
    def total_load(self) -> int:
        return sum(self.shard_loads)


@dataclasses.dataclass(frozen=True)
class TenantSensors:
    """One tenant's health, load and capacity."""

    name: str
    demoted: bool
    can_demote: bool
    last_active: float  # monotonic seconds of the last submit
    completed: int
    failed: int
    in_flight: int
    pending: int
    device_bytes: int
    p95_ms: Optional[float]  # the tenant's own, from the labelled histogram
    p99_ms: Optional[float]
    coords: Tuple[CoordinateSensors, ...]
    tier: str = "f32"
    can_quantize: bool = False

    @property
    def requests(self) -> int:
        return self.completed + self.failed


@dataclasses.dataclass(frozen=True)
class SensorSnapshot:
    """Everything one control-loop tick may base a decision on."""

    tenants: Dict[str, TenantSensors]
    hbm_budget: Optional[int]  # None: no device budget (the CPU)
    hbm_used: int
    latency_p95_ms: Optional[float]  # process-wide aggregates
    latency_p99_ms: Optional[float]
    queue_wait_p95_ms: Optional[float]
    batch_p50: Optional[float]
    failed_requests: int

    @property
    def hbm_pressure(self) -> Optional[float]:
        """Pinned bytes over the budget, or None when the budget is unknown."""
        if self.hbm_budget is None or self.hbm_budget <= 0:
            return None
        return self.hbm_used / float(self.hbm_budget)


def _quantile(name: str, q: float) -> Optional[float]:
    hist = telemetry.METRICS.histogram(name)
    return None if hist is None else hist.quantile(q)


def _labeled_quantiles(name: str, q: float) -> Dict[str, float]:
    """Per-label quantiles of one histogram ("tenant=a" -> p_q)."""
    out: Dict[str, float] = {}
    for key, snap in telemetry.METRICS.labeled_histograms(name).items():
        v = telemetry.snapshot_quantile(snap, q)
        if v is not None:
            out[key] = v
    return out


def read_sensors(registry) -> SensorSnapshot:
    """One coherent read over a TenantRegistry's fleet, from published
    surfaces only: telemetry histograms, each Tenant's counters and each
    engine's live bundle (`t.engine._state.bundle`). It never takes an
    engine's mutex, so sensing never waits on an actuation or a submit."""
    p95_by_label = _labeled_quantiles("serving_latency_ms", 0.95)
    p99_by_label = _labeled_quantiles("serving_latency_ms", 0.99)
    tenants: Dict[str, TenantSensors] = {}
    hbm_used = 0
    failed_total = 0
    for name in registry.tenant_names:
        try:
            t = registry.tenant(name)
        except KeyError:  # removed between the listing and the read
            continue
        bundle = t.engine._state.bundle
        coords = []
        for cid, c in bundle.coordinates.items():
            if not c.is_random_effect:
                continue
            sh, store = c.shard_health, c.store
            coords.append(CoordinateSensors(
                cid=cid, n_shards=sh.n_shards if sh is not None else 1, sharded=c.mesh is not None,
                two_tier=store is not None, shard_loads=sh.loads if sh is not None else (),
                promotions=sum(store.promotion_stats().values()) if store is not None else 0,
                device_bytes=c.device_nbytes()))
        device_bytes = t.device_bytes()
        hbm_used += device_bytes
        failed_total += t.failed
        label = f"tenant={t.name}"
        tenants[name] = TenantSensors(
            name=t.name, demoted=t.demoted, can_demote=t.can_demote(), last_active=t.last_active,
            completed=t.completed, failed=t.failed, in_flight=t.in_flight, pending=len(t.queue),
            device_bytes=device_bytes, p95_ms=p95_by_label.get(label), p99_ms=p99_by_label.get(label),
            coords=tuple(coords), tier=t.tier, can_quantize=t.can_quantize())
    device = registry._device
    budget = registry._fleet_budget(device) if device is not None else None
    return SensorSnapshot(
        tenants=tenants, hbm_budget=budget, hbm_used=hbm_used,
        latency_p95_ms=_quantile("serving_latency_ms", 0.95),
        latency_p99_ms=_quantile("serving_latency_ms", 0.99),
        queue_wait_p95_ms=_quantile("serving_queue_wait_ms", 0.95),
        batch_p50=_quantile("serving_batch_size", 0.5), failed_requests=failed_total)
