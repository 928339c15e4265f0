"""The supervised control loop: sensors -> rules -> actuators.

Port of `photon_ml_tpu/autopilot/loop.py`. `Autopilot` re-decides every
`PHOTON_AUTOPILOT_MS` from live telemetry over one `TenantRegistry`,
driving the actuators the port has on one card: the registry's host tier
(`demote` / `restore`), the engine's `reshard_orchestrator`
(`rebalance`, and `reshard` onto one card), and the planner's online
decision with `TenantRegistry.retune` (the wait retune), under the
reference's hygiene:

* per-rule hysteresis: a fired rule stays disarmed until its signal drops
  to its re-arm mark;
* per-rule cooldown (`PHOTON_AUTOPILOT_COOLDOWN_S`) and a bounded action
  budget (`PHOTON_AUTOPILOT_MAX_ACTIONS` a cooldown window) over all rules;
* one actuator mutex, and each actuator's own generation-change mutex, so
  an action and a swap or a delta order, never race;
* every decision journaled (`autopilot_decision`, applied or suppressed);
* a contract probe after each action (the probe requests' scores bit for
  bit, the latency within `probe_factor`, no new failed request): a
  regressing action is undone (`autopilot_rollback`, counter
  `autopilot_rollbacks`) and its rule quarantined (`rule_quarantined`,
  `autopilot_quarantines`) until `reset_rule`.

The `autopilot_act` fault site fires between a decision and its effect.
The precision ladder's actions (`tier_demote`, `tier_restore`) raise
(ROADMAP item 10f), so the loop rolls them back and quarantines their rule
as it does any failed actuation.

The port ends what the reference logs and survives (there is no
fallback): the `photon-autopilot` worker dies on a tick that raises
outside a rule's evaluation, and on a rollback whose undo fails, and
`close()` then raises `AutopilotFailure`. The worker makes its CUDA calls
on the registry's device.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Mapping, Optional

import numpy as np

from photon_ml_tpu_torch.autopilot.rules import Action, ControlRule, default_rules
from photon_ml_tpu_torch.autopilot.sensors import SensorSnapshot, read_sensors
from photon_ml_tpu_torch.contracts import AUTOPILOT_BLOCK_KEYS
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

__all__ = ["Autopilot", "AutopilotFailure", "OUTCOMES"]

# Decision outcomes the journal carries; only "applied" actuated.
OUTCOMES = ("applied", "suppressed_quarantined", "suppressed_cooldown", "suppressed_budget",
            "rolled_back")


class AutopilotFailure(RuntimeError):
    """The loop cannot keep its contract: an undo failed, or the worker
    died. Never swallowed by the loop."""


class Autopilot:
    """The closed-loop controller over one TenantRegistry.

    `start=True` spawns the `photon-autopilot` worker ticking every
    `tick_ms`; `start=False` leaves it inert for deterministic drive by
    `tick()`. Arguments left None take the PHOTON_AUTOPILOT_* knobs.
    `probe_requests` maps a tenant to a ScoreRequest whose answer must stay
    bit for bit across any action (every actuator of the port is
    bit-neutral); without it the probe checks failed requests only.
    `sensor_fn` replaces `read_sensors` (scripted snapshots)."""

    def __init__(self, registry, *, rules: Optional[List[ControlRule]] = None,
                 tick_ms: Optional[int] = None, cooldown_s: Optional[float] = None,
                 max_actions: Optional[int] = None,
                 probe_requests: Optional[Mapping[str, object]] = None, probe_factor: float = 5.0,
                 probe_floor_ms: float = 50.0,
                 sensor_fn: Optional[Callable[[object], SensorSnapshot]] = None, start: bool = True):
        self.registry = registry
        self.rules: List[ControlRule] = list(rules) if rules is not None else default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {sorted(names)}")
        self.tick_ms = int(get_knob("PHOTON_AUTOPILOT_MS")) if tick_ms is None else int(tick_ms)
        self.cooldown_s = (float(get_knob("PHOTON_AUTOPILOT_COOLDOWN_S")) if cooldown_s is None
                           else float(cooldown_s))
        self.max_actions = (int(get_knob("PHOTON_AUTOPILOT_MAX_ACTIONS")) if max_actions is None
                            else int(max_actions))
        if self.tick_ms < 1:
            raise ValueError("tick_ms must be >= 1")
        if self.max_actions < 1:
            raise ValueError("max_actions must be >= 1")
        self._probe_requests = dict(probe_requests or {})
        self._probe_factor = float(probe_factor)
        self._probe_floor_ms = float(probe_floor_ms)
        self._sensor_fn = sensor_fn if sensor_fn is not None else read_sensors
        self._act_lock = threading.Lock()  # actuations serialize here
        self._cv = threading.Condition()
        self._stop = False
        self._error: Optional[BaseException] = None
        self._prev: Optional[SensorSnapshot] = None
        self._window: Deque[float] = collections.deque()  # applied actions' stamps
        self._ticks = 0
        self._decisions = 0
        self._actions = 0
        self._suppressed = 0
        self._rollbacks = 0
        self._last_outcome: Optional[str] = None
        self._worker: Optional[threading.Thread] = None
        if start:
            self._worker = threading.Thread(target=self._run, name="photon-autopilot", daemon=True)
            self._worker.start()

    # ------------------------------------------------------------ lifecycle

    def _device_scope(self):
        """The registry's card as the worker's current device."""
        dev = getattr(self.registry, "_device", None)
        if dev is not None and dev.type == "cuda":
            import torch

            return torch.cuda.device(dev)
        return contextlib.nullcontext()

    def _run(self) -> None:
        try:
            with self._device_scope():
                while True:
                    with self._cv:
                        if self._stop:
                            return
                        self._cv.wait(timeout=self.tick_ms / 1e3)
                        if self._stop:
                            return
                    self.tick()
        except BaseException as exc:  # the worker's last guard: close() raises it
            logger.error("photon-autopilot thread died: %r", exc)
            with self._cv:
                self._error = exc

    def close(self) -> None:
        """Stop the loop and join the worker; raises AutopilotFailure if the
        worker died. Idempotent."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        w, self._worker = self._worker, None
        if w is not None:
            w.join(timeout=30.0)
        if self._error is not None:
            raise AutopilotFailure(f"photon-autopilot thread died: {self._error!r}") from self._error

    def __enter__(self) -> "Autopilot":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ----------------------------------------------------------------- tick

    def tick(self) -> SensorSnapshot:
        """One synchronous pass: read the sensors, evaluate every rule
        against (current, previous). Returns the snapshot it acted on."""
        cur = self._sensor_fn(self.registry)
        prev, self._prev = self._prev, cur
        self._ticks += 1
        for rule in self.rules:
            try:
                self._evaluate(rule, cur, prev)
            except AutopilotFailure:
                raise
            except Exception:  # one rule's evaluation must not end the pass
                logger.exception("rule %r evaluation failed", rule.name)
        return cur

    def _evaluate(self, rule: ControlRule, cur: SensorSnapshot, prev: Optional[SensorSnapshot]) -> None:
        sig = rule.signal(cur, prev)
        if sig is None:
            return
        sig = float(sig)
        if not rule.armed:
            # Hysteresis: re-arming is silent, and a disarmed rule holds
            # without journaling while its signal stays up.
            if sig <= rule.rearm_below:
                rule.armed = True
            return
        if sig < rule.fire_above:
            return
        evidence = {"signal": sig, "fire_above": rule.fire_above, "rearm_below": rule.rearm_below}
        if rule.quarantined:
            self._record(rule, None, evidence, "suppressed_quarantined")
            return
        cooldown = rule.cooldown_s if rule.cooldown_s is not None else self.cooldown_s
        now = time.monotonic()
        if cooldown > 0 and rule.last_actuated is not None and now - rule.last_actuated < cooldown:
            self._record(rule, None, {**evidence, "cooldown_s": cooldown}, "suppressed_cooldown")
            return
        window_s = self.cooldown_s if self.cooldown_s > 0 else 1.0
        while self._window and now - self._window[0] > window_s:
            self._window.popleft()
        if len(self._window) >= self.max_actions:
            self._record(rule, None, {**evidence, "budget": self.max_actions, "window_s": window_s},
                         "suppressed_budget")
            return
        action = rule.decide(cur, prev, sig)
        if action is None:
            return  # declined: a hold, not a decision
        action = Action(kind=action.kind, tenant=action.tenant, params=action.params,
                        evidence={**evidence, **action.evidence}, apply_fn=action.apply_fn,
                        undo_fn=action.undo_fn)
        rule.armed = False  # fired: disarmed until the signal re-arms it
        self._actuate(rule, action)

    # ------------------------------------------------------------ actuation

    def _actuate(self, rule: ControlRule, action: Action) -> None:
        now = time.monotonic()
        undo: Optional[Callable[[], None]] = None
        with self._act_lock:
            pre = self._probe()
            try:
                faults.fault_point("autopilot_act")
                undo = self._apply(action)
            except Exception as exc:  # rolled back and quarantined below
                self._rollback(rule, action, f"actuation failed: {exc}", None)
                return
            post = self._probe()
            regression = self._probe_regressed(pre, post)
            if regression is not None:
                self._rollback(rule, action, regression, undo)
                return
        rule.last_actuated = now
        self._window.append(now)
        self._actions += 1
        telemetry.METRICS.increment("autopilot_actions")
        self._record(rule, action, action.evidence, "applied")

    def _apply(self, action: Action) -> Optional[Callable[[], None]]:
        """Dispatch one action to its actuator; returns the undo closure."""
        if action.apply_fn is not None:
            action.apply_fn()
            return action.undo_fn
        kind = action.kind
        if kind == "reshard":
            return self._apply_reshard(action)
        if kind == "rebalance":
            t = self.registry.tenant(action.tenant)
            t.engine.reshard_orchestrator.rebalance(action.params["cid"])
            # Bit-neutral placement from observed stats: nothing to restore.
            return None
        if kind == "demote":
            name = action.tenant
            self.registry.demote(name, hot_rows=int(action.params.get("hot_rows", 0)),
                                 reason="autopilot")
            return lambda: self.registry.restore(name, reason="autopilot-rollback")
        if kind == "restore":
            name = action.tenant
            self.registry.restore(name, reason="autopilot")
            return lambda: self.registry.demote(name, reason="autopilot-rollback")
        if kind == "tier_demote":
            self.registry.demote_tier(action.tenant, to=action.params.get("to"), reason="autopilot")
            return None
        if kind == "tier_restore":
            self.registry.restore_tier(action.tenant, to=str(action.params.get("to", "f32")),
                                       reason="autopilot")
            return None
        if kind == "retune":
            return self._apply_retune(action)
        raise ValueError(f"unknown action kind {kind!r}")

    def _apply_reshard(self, action: Action) -> Callable[[], None]:
        """Onto `devices` cards (None: every card of the registry's kind).
        One card is the one-shard restage; two or more raise (item 9c)."""
        import torch

        orch = self.registry.tenant(action.tenant).engine.reshard_orchestrator
        dev = self.registry._device
        count = torch.cuda.device_count() if dev is not None and dev.type == "cuda" else 1
        n = action.params.get("devices")
        n = count if n is None else max(1, min(int(n), count))
        orch.reshard(n if n > 1 else None)
        return lambda: orch.reshard(None)

    def _apply_retune(self, action: Action) -> Optional[Callable[[], None]]:
        from photon_ml_tpu_torch import planner

        value = float(action.params["serving_max_wait_ms"])
        decision = planner.apply_online_decision("serving_max_wait_ms", value,
                                                 evidence=dict(action.evidence))
        if decision is None:
            return None  # an explicit knob pins the quantity: hold
        prev = self.registry.retune(max_wait_ms=value)

        def _undo() -> None:
            planner.apply_online_decision("serving_max_wait_ms", decision.fallback,
                                          evidence={"rollback_of": value})
            self.registry.retune(max_wait_ms=prev["max_wait_ms"])

        return _undo

    # ---------------------------------------------------------------- probe

    def _probe(self) -> Dict[str, object]:
        """Each tenant's failed-request count, and each probe request's
        scores and best-of-3 wall."""
        failed = {}
        for name in self.registry.tenant_names:
            try:
                failed[name] = self.registry.tenant(name).failed
            except KeyError:
                continue
        probes: Dict[str, Dict[str, object]] = {}
        for name, req in self._probe_requests.items():
            if name not in failed:
                continue
            walls = []
            scores = None
            for _ in range(3):
                t0 = time.monotonic()
                res = self.registry.score(name, req)
                walls.append(time.monotonic() - t0)
                scores = np.asarray([res.score, res.mean], np.float64)
            probes[name] = {"scores": scores, "wall_s": min(walls)}
        return {"failed": failed, "probes": probes}

    def _probe_regressed(self, pre: Dict[str, object], post: Dict[str, object]) -> Optional[str]:
        """None when the post-action probe holds the contract, else why not."""
        for name, n_pre in pre["failed"].items():
            n_post = post["failed"].get(name, n_pre)
            if n_post > n_pre:
                return f"failed requests regressed for tenant {name!r} ({n_pre} -> {n_post})"
        for name, p in pre["probes"].items():
            q = post["probes"].get(name)
            if q is None:
                continue
            if not np.array_equal(p["scores"], q["scores"]):
                return f"bitwise spot-check failed for tenant {name!r}"
            bound = max(p["wall_s"] * self._probe_factor, p["wall_s"] + self._probe_floor_ms / 1e3)
            if q["wall_s"] > bound:
                return (f"probe latency regressed for tenant {name!r} ({p['wall_s'] * 1e3:.2f}ms -> "
                        f"{q['wall_s'] * 1e3:.2f}ms)")
        return None

    # ----------------------------------------------- rollback / quarantine

    def _rollback(self, rule: ControlRule, action: Action, reason: str,
                  undo: Optional[Callable[[], None]]) -> None:
        if undo is not None:
            try:
                undo()
            except Exception as exc:
                raise AutopilotFailure(f"rollback of {rule.name!r} ({action.kind}) failed: "
                                       f"{exc!r}") from exc
        self._rollbacks += 1
        rule.rollbacks += 1
        faults.COUNTERS.increment("autopilot_rollbacks")
        telemetry.emit_event("autopilot_rollback", rule=rule.name, action=action.describe(),
                             reason=reason)
        self._record(rule, action, action.evidence, "rolled_back")
        # One rollback quarantines the rule until an operator's reset_rule.
        if not rule.quarantined:
            rule.quarantined = True
            faults.COUNTERS.increment("autopilot_quarantines")
            telemetry.emit_event("rule_quarantined", rule=rule.name, reason=reason,
                                 rollbacks=rule.rollbacks)
            logger.warning("autopilot rule %r quarantined after rollback: %s", rule.name, reason)

    def reset_rule(self, name: str) -> None:
        """Lift a rule's quarantine and re-arm it: the only way out."""
        for rule in self.rules:
            if rule.name == name:
                rule.quarantined = False
                rule.armed = True
                logger.info("autopilot rule %r reset by operator", name)
                return
        raise KeyError(f"unknown rule {name!r} (rules: {[r.name for r in self.rules]})")

    # ------------------------------------------------------------ reporting

    def _record(self, rule: ControlRule, action: Optional[Action], evidence: Mapping[str, object],
                outcome: str) -> None:
        assert outcome in OUTCOMES, outcome
        self._decisions += 1
        self._last_outcome = outcome
        if outcome.startswith("suppressed"):
            self._suppressed += 1
            telemetry.METRICS.increment("autopilot_suppressed")
        telemetry.emit_event("autopilot_decision", rule=rule.name,
                             action=action.describe() if action is not None else None,
                             evidence=dict(evidence), outcome=outcome)

    def summary(self) -> Dict[str, object]:
        """The `autopilot` block (contracts.AUTOPILOT_BLOCK_KEYS, in order)."""
        return dict(zip(AUTOPILOT_BLOCK_KEYS, (
            "stopped" if self._stop or self._worker is None else "running", self._ticks,
            [r.name for r in self.rules], self._decisions, self._actions, self._suppressed,
            self._rollbacks, [r.name for r in self.rules if r.quarantined], self.tick_ms,
            self.cooldown_s, self.max_actions, self._last_outcome)))
