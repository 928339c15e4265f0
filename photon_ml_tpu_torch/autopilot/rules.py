"""Declarative control rules of the autopilot.

Port of `photon_ml_tpu/autopilot/rules.py`. A `ControlRule` is (signal,
hysteresis band, decide): the signal maps a (current, previous) snapshot
pair to one number, the band says when it may fire (`fire_above`) and
when a fired rule re-arms (`rearm_below`), and `decide` turns a firing
into one `Action` for the loop's actuators. Rules carry their own control
state (armed, quarantined, rollbacks, last actuation); the loop owns the
hygiene (cooldown, action budget, rollback, quarantine).

The five rules are the reference's, in its order (`default_rules`): the
device-memory ladder (demote, restore), placement (shard grow, hot-row
rebalance), then the wait retune, which writes through
`planner.apply_online_decision` and so yields to an operator's knob.
`hbm_demote_rule` leaves out the reference's PHOTON_TIER_LADDER branch:
the precision ladder is ROADMAP item 10f, and its knob is not registered.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from photon_ml_tpu_torch.autopilot.sensors import SensorSnapshot

__all__ = ["Action", "ControlRule", "default_rules"]

# Action kinds the loop's dispatch understands (the ladder's two raise
# until item 10f).
ACTION_KINDS = ("reshard", "rebalance", "demote", "restore", "retune", "tier_demote", "tier_restore")


@dataclasses.dataclass(frozen=True)
class Action:
    """One decided actuation. `kind`, `tenant` and `params` are journaled;
    `evidence` is the sensor data that chose it. `apply_fn`/`undo_fn` let
    a custom rule bypass the built-in dispatch; they are never journaled."""

    kind: str
    tenant: Optional[str] = None
    params: Dict[str, object] = dataclasses.field(default_factory=dict)
    evidence: Dict[str, object] = dataclasses.field(default_factory=dict)
    apply_fn: Optional[Callable[[], Optional[Callable[[], None]]]] = None
    undo_fn: Optional[Callable[[], None]] = None

    def describe(self) -> Dict[str, object]:
        return {"kind": self.kind, "tenant": self.tenant, "params": dict(self.params)}


@dataclasses.dataclass
class ControlRule:
    """One policy and its control state. `signal(cur, prev)` returns None
    when there is no evidence (a None never fires and never re-arms);
    `decide(cur, prev, signal)` runs on an armed, in-band, in-budget firing
    and may decline with None (a hold, not a suppression)."""

    name: str
    signal: Callable[[SensorSnapshot, Optional[SensorSnapshot]], Optional[float]]
    fire_above: float
    rearm_below: float
    decide: Callable[[SensorSnapshot, Optional[SensorSnapshot], float], Optional[Action]]
    cooldown_s: Optional[float] = None  # None: the loop's knob
    # The control state (the loop's).
    armed: bool = True
    quarantined: bool = False
    rollbacks: int = 0
    last_actuated: Optional[float] = None

    def __post_init__(self) -> None:
        if self.rearm_below > self.fire_above:
            raise ValueError(
                f"rule {self.name!r}: rearm_below ({self.rearm_below}) must not exceed fire_above "
                f"({self.fire_above}) — an inverted band fires and re-arms on the same value, which "
                "is an oscillator, not hysteresis")


def _delta_loads(cur: SensorSnapshot, prev: Optional[SensorSnapshot]) -> Dict[str, int]:
    """Each tenant's request-row load since the previous snapshot, over its
    random effects' shard loads."""
    if prev is None:
        return {}
    out: Dict[str, int] = {}
    for name, t in cur.tenants.items():
        p = prev.tenants.get(name)
        if p is None:
            continue
        out[name] = max(0, sum(c.total_load for c in t.coords) - sum(c.total_load for c in p.coords))
    return out


def _growable(cur: SensorSnapshot, name: str) -> bool:
    t = cur.tenants[name]
    return not t.demoted and any(not c.sharded and not c.two_tier and c.n_shards == 1
                                 for c in t.coords)


def shard_grow_rule(*, fire_above: float = 2048.0, rearm_below: float = 256.0,
                    devices: Optional[int] = None) -> ControlRule:
    """Shard grow from load: when one tenant's single-shard random effects
    absorb a heavy load delta, reshard its engine onto `devices` cards
    (None: every card). On one card that is the one-shard restage; two or
    more cards raise (ROADMAP item 9c), and the loop rolls the action back
    and quarantines the rule."""

    def signal(cur, prev):
        deltas = _delta_loads(cur, prev)
        if not deltas:
            return None
        growable = [d for n, d in deltas.items() if _growable(cur, n)]
        return float(max(growable)) if growable else 0.0

    def decide(cur, prev, sig):
        deltas = _delta_loads(cur, prev)
        name = max((n for n in deltas if _growable(cur, n)), key=lambda n: deltas[n], default=None)
        if name is None:
            return None
        return Action(kind="reshard", tenant=name, params={"devices": devices},
                      evidence={"load_delta": deltas[name],
                                "loads": {n: d for n, d in sorted(deltas.items())}})

    return ControlRule(name="shard-grow", signal=signal, fire_above=fire_above,
                       rearm_below=rearm_below, decide=decide)


def rebalance_rule(*, fire_above: float = 64.0, rearm_below: float = 8.0) -> ControlRule:
    """Hot-row rebalance on promotion pressure: when a two-tier store keeps
    promoting cold rows, re-place its hot set from the promotion stats."""

    def _pressures(cur, prev):
        if prev is None:
            return {}
        out = {}
        for name, t in cur.tenants.items():
            p = prev.tenants.get(name)
            if p is None:
                continue
            prev_promos = {c.cid: c.promotions for c in p.coords}
            for c in t.coords:
                if c.two_tier:
                    d = c.promotions - prev_promos.get(c.cid, 0)
                    if d > 0:
                        out[(name, c.cid)] = d
        return out

    def signal(cur, prev):
        if prev is None:
            return None
        pressures = _pressures(cur, prev)
        return float(max(pressures.values())) if pressures else 0.0

    def decide(cur, prev, sig):
        pressures = _pressures(cur, prev)
        if not pressures:
            return None
        (tenant, cid), delta = max(pressures.items(), key=lambda kv: kv[1])
        return Action(kind="rebalance", tenant=tenant, params={"cid": cid},
                      evidence={"promotion_delta": delta, "cid": cid})

    return ControlRule(name="hot-row-rebalance", signal=signal, fire_above=fire_above,
                       rearm_below=rearm_below, decide=decide)


def hbm_demote_rule(*, fire_above: float = 0.85, rearm_below: float = 0.6,
                    hot_rows: int = 0) -> ControlRule:
    """Device memory, downward: under budget pressure, demote the least
    recently active demotable tenant to the host tier (`hot_rows` rows a
    random effect kept on the card)."""

    def signal(cur, prev):
        return cur.hbm_pressure

    def decide(cur, prev, sig):
        victims = [t for t in cur.tenants.values() if t.can_demote]
        if not victims:
            return None
        victim = min(victims, key=lambda t: t.last_active)
        return Action(kind="demote", tenant=victim.name, params={"hot_rows": hot_rows},
                      evidence={"hbm_pressure": sig, "hbm_used": cur.hbm_used,
                                "hbm_budget": cur.hbm_budget, "victim_bytes": victim.device_bytes})

    return ControlRule(name="hbm-demote", signal=signal, fire_above=fire_above,
                       rearm_below=rearm_below, decide=decide)


def hbm_restore_rule(*, fire_above: float = 0.5, rearm_below: float = 0.25,
                     ceiling: float = 0.8) -> ControlRule:
    """Device memory, upward: when headroom returns (the signal is the
    budget's free fraction) and a degraded tenant exists, bring the most
    recently active one back, unless the pressure already sits at
    `ceiling` (restoring into the demote band would oscillate)."""

    def signal(cur, prev):
        p = cur.hbm_pressure
        if p is None:
            return None
        if not any(t.demoted or t.tier != "f32" for t in cur.tenants.values()):
            return None  # nothing to restore: no evidence either way
        return 1.0 - p

    def decide(cur, prev, sig):
        degraded = [t for t in cur.tenants.values() if t.demoted or t.tier != "f32"]
        if not degraded or cur.hbm_budget is None:
            return None
        t = max(degraded, key=lambda t: t.last_active)
        p = cur.hbm_pressure
        if p is not None and p >= ceiling:
            return None
        evidence = {"hbm_headroom": sig, "hbm_used": cur.hbm_used, "hbm_budget": cur.hbm_budget}
        if t.demoted:
            return Action(kind="restore", tenant=t.name, params={}, evidence=evidence)
        return Action(kind="tier_restore", tenant=t.name,
                      params={"to": "f32" if t.tier == "bf16" else "bf16"},
                      evidence={**evidence, "from_tier": t.tier})

    return ControlRule(name="hbm-restore", signal=signal, fire_above=fire_above,
                       rearm_below=rearm_below, decide=decide)


def retune_rule(*, fire_above: float = 5.0, rearm_below: float = 1.5,
                floor_ms: float = 0.25) -> ControlRule:
    """Wait retune from fresh p95s: when the p95 queue wait dwarfs the
    configured flush wait (the batcher is starved, not saturated), halve
    `serving_max_wait_ms` through the planner's online decision (a knob
    pinning it refuses)."""

    def signal(cur, prev):
        from photon_ml_tpu_torch import planner

        w = cur.queue_wait_p95_ms
        if w is None:
            return None
        return w / max(float(planner.planned_value("serving_max_wait_ms")), 1e-6)

    def decide(cur, prev, sig):
        from photon_ml_tpu_torch import planner

        current = float(planner.planned_value("serving_max_wait_ms"))
        new = max(floor_ms, current / 2.0)
        if new >= current:
            return None
        return Action(kind="retune", tenant=None, params={"serving_max_wait_ms": new},
                      evidence={"queue_wait_p95_ms": cur.queue_wait_p95_ms,
                                "configured_wait_ms": current, "wait_ratio": sig})

    return ControlRule(name="wait-retune", signal=signal, fire_above=fire_above,
                       rearm_below=rearm_below, decide=decide)


def default_rules() -> List[ControlRule]:
    """The stock policy set, in evaluation order: the capacity ladder first,
    then placement, then tuning."""
    return [hbm_demote_rule(), hbm_restore_rule(), shard_grow_rule(), rebalance_rule(),
            retune_rule()]
