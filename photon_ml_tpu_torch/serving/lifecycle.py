"""Serving lifecycle: typed failures, health states, circuit breaking and
versioned hot-swap.

Port of `photon_ml_tpu/serving/lifecycle.py`:

* Typed failures: `Overloaded` (admission shed the request),
  `DeadlineExceeded` (the request expired in queue; a TimeoutError),
  `BatcherUnhealthy` (the flush thread died), `HbmBudgetExceeded` (a swap
  would not fit device memory), `SwapIncompatible` (the next bundle does not
  fit the engine's program family).
* `ServingState` and `HealthStateMachine`: STARTING -> READY <-> DEGRADED
  -> DRAINING -> CLOSED, with DEGRADED tracked by reason (READY returns
  only when every reason has cleared). Transitions are journalled.
* `CircuitBreaker`: counts consecutive device-class failures that outlived
  the retry policy; at `threshold` it opens and traffic is answered by the
  fixed-effect-only tier; after `probe_interval_s` one probe may use the
  full path (HALF_OPEN), and its outcome closes or re-opens the circuit.
  Every permit is resolved by exactly one of on_success / on_failure /
  on_abandon.
* `BundleManager.swap`: the device-memory check, staging (the `swap_stage`
  fault site, retried), the compatibility check, the pre-warm of every
  bucket program for the new generation (on the card: new CUDA graphs), the
  `swap_commit` fault site, the atomic flip between batches, the drain of
  in-flight batches and the release of the old generation. A failure before
  the flip rolls back: the old bundle never stopped serving. The delta
  apply (serving/delta.py) runs the same sequence (`_stage_and_commit`,
  the reference's reshard primitive with kind "delta"): staging under
  `shard_upload`, then the `reshard_commit` site, its flip journalled as
  `reshard_commit` (one shard to one, as the reference's), its rollback
  counted in `delta_rollbacks` and journalled as `delta_rollback`.
"""

from __future__ import annotations

import collections
import enum
import logging
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ typed failures


class Overloaded(RuntimeError):
    """Admission control rejected the request: the pending queue is full (or
    an armed `admit` fault shed it). `tenant` names the tenant on the
    multi-tenant registry's path, None on a single-tenant batcher's."""

    def __init__(self, *args, tenant: Optional[str] = None):
        super().__init__(*args)
        self.tenant = tenant


class DeadlineExceeded(TimeoutError):
    """The request's deadline budget expired while it waited in queue; it
    was failed before it took a device slot. `tenant` as in Overloaded."""

    def __init__(self, *args, tenant: Optional[str] = None):
        super().__init__(*args)
        self.tenant = tenant


class BatcherUnhealthy(RuntimeError):
    """The micro-batcher's flush thread died; every pending future was failed
    with its error and new submits are refused."""


class HbmBudgetExceeded(RuntimeError):
    """Staging the next bundle beside the active one would exceed the
    device-memory budget; nothing was staged."""


class SwapIncompatible(ValueError):
    """The next bundle's coordinates (ids, kinds, shards, widths) do not
    match the engine's program family."""


# -------------------------------------------------------------- health state


class ServingState(enum.Enum):
    STARTING = "STARTING"
    READY = "READY"
    DEGRADED = "DEGRADED"
    DRAINING = "DRAINING"
    CLOSED = "CLOSED"


_TRANSITIONS = {
    ServingState.STARTING: {ServingState.READY, ServingState.DEGRADED, ServingState.DRAINING,
                            ServingState.CLOSED},
    ServingState.READY: {ServingState.DEGRADED, ServingState.DRAINING, ServingState.CLOSED},
    ServingState.DEGRADED: {ServingState.READY, ServingState.DRAINING, ServingState.CLOSED},
    ServingState.DRAINING: {ServingState.CLOSED},
    ServingState.CLOSED: set(),
}


class HealthStateMachine:
    """Thread-safe serving health with degradation tracked by reason."""

    HISTORY_LIMIT = 64  # transitions kept for the snapshot; the total is counted apart

    def __init__(self):
        self._lock = threading.Lock()
        self._state = ServingState.STARTING
        self._reasons: List[str] = []
        self._history: Deque[Tuple[float, str, str]] = collections.deque(
            [(time.monotonic(), "", ServingState.STARTING.value)], maxlen=self.HISTORY_LIMIT)
        self._transitions_total = 0

    @property
    def state(self) -> ServingState:
        with self._lock:
            return self._state

    @property
    def degraded_reasons(self) -> List[str]:
        with self._lock:
            return list(self._reasons)

    def _to_locked(self, new: ServingState) -> None:
        if new is self._state:
            return
        if new not in _TRANSITIONS[self._state]:
            raise RuntimeError(f"illegal serving-state transition {self._state.value} -> {new.value}")
        self._history.append((time.monotonic(), self._state.value, new.value))
        self._transitions_total += 1
        logger.info("serving state %s -> %s", self._state.value, new.value)
        telemetry.emit_event("health_transition", from_state=self._state.value,
                             to_state=new.value, reasons=list(self._reasons))
        self._state = new

    def mark_ready(self) -> None:
        """STARTING -> READY (DEGRADED if reasons accrued); a no-op later."""
        with self._lock:
            if self._state is ServingState.STARTING:
                self._to_locked(ServingState.DEGRADED if self._reasons else ServingState.READY)

    def add_degraded(self, reason: str) -> None:
        with self._lock:
            if reason not in self._reasons:
                self._reasons.append(reason)
            if self._state is ServingState.READY:
                self._to_locked(ServingState.DEGRADED)

    def clear_degraded(self, reason: str) -> None:
        with self._lock:
            if reason in self._reasons:
                self._reasons.remove(reason)
            if self._state is ServingState.DEGRADED and not self._reasons:
                self._to_locked(ServingState.READY)

    def begin_drain(self) -> None:
        with self._lock:
            if self._state not in (ServingState.DRAINING, ServingState.CLOSED):
                self._to_locked(ServingState.DRAINING)

    def close(self) -> None:
        with self._lock:
            if self._state is not ServingState.CLOSED:
                if self._state is not ServingState.DRAINING:
                    self._to_locked(ServingState.DRAINING)
                self._to_locked(ServingState.CLOSED)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"state": self._state.value, "degraded_reasons": list(self._reasons),
                    "transitions_total": self._transitions_total,
                    "transitions": [{"t": round(t, 4), "from": a, "to": b}
                                    for t, a, b in self._history if a]}


# ------------------------------------------------------------ circuit breaker


class CircuitState(enum.Enum):
    CLOSED = "CLOSED"
    OPEN = "OPEN"
    HALF_OPEN = "HALF_OPEN"


class CircuitPermit:
    """One full-path attempt's token; `probe` marks the half-open probe."""

    __slots__ = ("probe",)

    def __init__(self, probe: bool):
        self.probe = probe


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    `acquire()` returns a permit (free while CLOSED), or None while OPEN
    (answer FE-only) until `probe_interval_s` has passed, when exactly one
    caller gets the probe permit. Every permit is resolved by one of
    `on_success` (a probe re-closes), `on_failure` (re-opens, re-arms the
    interval) or `on_abandon` (the attempt failed for a reason that says
    nothing about the device)."""

    def __init__(self, *, threshold: int = 5, probe_interval_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_open: Optional[Callable[[], None]] = None,
                 on_close: Optional[Callable[[], None]] = None):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.probe_interval_s = float(probe_interval_s)
        self._clock = clock
        self._on_open = on_open
        self._on_close = on_close
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._consecutive = 0
        self._probing = False
        self._next_probe_t = 0.0
        self._opens = 0
        self._probes = 0

    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._state

    def acquire(self) -> Optional[CircuitPermit]:
        with self._lock:
            if self._state is CircuitState.CLOSED:
                return CircuitPermit(probe=False)
            if self._state is CircuitState.OPEN and self._clock() >= self._next_probe_t:
                self._state = CircuitState.HALF_OPEN
                self._probing = True
                self._probes += 1
                return CircuitPermit(probe=True)
            if self._state is CircuitState.HALF_OPEN and not self._probing:
                self._probing = True
                self._probes += 1
                return CircuitPermit(probe=True)
            return None

    def on_success(self, permit: CircuitPermit) -> None:
        notify = False
        with self._lock:
            if permit.probe:
                self._probing = False
            self._consecutive = 0
            # Only the probe may close an open circuit: a permit taken
            # before the failures that opened it says nothing about now.
            if permit.probe and self._state is not CircuitState.CLOSED:
                self._state = CircuitState.CLOSED
                notify = True
                logger.info("serving circuit re-closed (probe succeeded)")
        if notify and self._on_close is not None:
            self._on_close()

    def on_failure(self, permit: CircuitPermit) -> None:
        notify = False
        with self._lock:
            if permit.probe:
                self._probing = False
            self._consecutive += 1
            should_open = ((permit.probe and self._state is CircuitState.HALF_OPEN)
                           or self._consecutive >= self.threshold)
            if should_open and self._state is not CircuitState.OPEN:
                self._state = CircuitState.OPEN
                self._opens += 1
                notify = True
                logger.warning("serving circuit OPEN after %d consecutive device failure(s); "
                               "probing in %.2fs", self._consecutive, self.probe_interval_s)
            if self._state is CircuitState.OPEN:
                self._next_probe_t = self._clock() + self.probe_interval_s
        if notify:
            faults.COUNTERS.increment("serving_circuit_opens")
            if self._on_open is not None:
                self._on_open()

    def on_abandon(self, permit: CircuitPermit) -> None:
        """Return a permit whose attempt failed for a non-device reason."""
        if permit.probe:
            with self._lock:
                self._probing = False

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {"circuit_state": self._state.value, "circuit_opens": self._opens,
                    "circuit_probes": self._probes,
                    "consecutive_device_failures": self._consecutive}


# --------------------------------------------------------------- bundle swap


def device_memory_budget_bytes(device: torch.device) -> Optional[int]:
    """The device-memory budget a swap must fit in: PHOTON_SERVING_HBM_
    BUDGET_BYTES when set, else the card's total memory; None on the CPU
    (no check)."""
    budget = int(get_knob("PHOTON_SERVING_HBM_BUDGET_BYTES"))
    if budget > 0:
        return budget
    if torch.device(device).type == "cuda":
        return int(torch.cuda.get_device_properties(torch.device(device)).total_memory)
    return None


def _bundle_device_bytes(bundle) -> int:
    """A bundle's device bytes for a device-memory budget, the peak on one
    card: every pinned plane, a two-tier coordinate's hot plane (not its
    host matrix), a row-sharded matrix's bytes over its shards."""
    return int(bundle.device_bytes_per_shard())


# How long a swap waits for in-flight batches of the old generation before
# it leaves that generation allocated.
SWAP_DRAIN_TIMEOUT_S = 30.0

# Generation changes that keep the program family and commit through the
# reshard sequence's site and journal lines.
_RESHARD_KINDS = ("delta", "reshard", "rebalance")


class BundleManager:
    """Versioned, atomic, rollback-safe generation changes of a
    ServingEngine: `swap` (a whole next bundle) and the delta apply
    (serving/delta.apply_delta) run the one sequence `_stage_and_commit`
    under one mutex, so generation changes are serialized. The swap's budget
    check charges both generations' device bytes and the engine's static
    bucket buffers of the new generation (allocated beside the two during
    the pre-warm)."""

    def __init__(self, engine):
        self.engine = engine
        self._swap_lock = threading.Lock()
        self._swaps = 0
        self._rollbacks = 0
        self._deltas = 0

    @property
    def mutex(self) -> threading.Lock:
        """The generation-change mutex (swaps and delta applies)."""
        return self._swap_lock

    @property
    def swaps(self) -> int:
        return self._swaps

    @property
    def rollbacks(self) -> int:
        return self._rollbacks

    @property
    def deltas(self) -> int:
        """Delta bundles committed."""
        return self._deltas

    def swap(self, next_bundle, *, expected_bytes: Optional[int] = None,
             hbm_budget_bytes: Optional[int] = None) -> Dict[str, object]:
        """Replace the engine's bundle with `next_bundle` (a ServingBundle,
        or a zero-argument builder returning one: then the budget check runs
        before anything is allocated, on `expected_bytes`) under live
        traffic. Staging fires the `swap_stage` site (retried), the flip the
        `swap_commit` site. Returns the new version, the staging seconds and
        the bucket programs the pre-warm built; any failure before the flip
        rolls back and re-raises."""
        with self._swap_lock:
            engine = self.engine
            old_state = engine._state
            builder = next_bundle if callable(next_bundle) else None
            budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                      else device_memory_budget_bytes(engine.device))
            need = expected_bytes
            if need is None and builder is None:
                need = _bundle_device_bytes(next_bundle) or None
            have = _bundle_device_bytes(old_state.bundle)
            warm = engine.warmup_buffer_bytes()
            if budget is not None and need is not None and have + need + warm > budget:
                raise HbmBudgetExceeded(
                    f"staging {need} bytes beside the active bundle's {have} bytes + {warm} bytes "
                    f"of bucket buffers exceeds the {budget}-byte device-memory budget; swap "
                    "refused before staging")

            def stage():
                def attempt():
                    faults.fault_point("swap_stage")
                    return builder() if builder is not None else next_bundle

                staged = faults.retry(attempt, label="bundle swap staging")
                if staged.released:
                    raise SwapIncompatible("next bundle is already released")
                return staged

            def check_budget(new_state) -> None:
                got = _bundle_device_bytes(new_state.bundle)
                warm_new = engine.warmup_buffer_bytes(new_state)
                if budget is not None and have + got + max(warm, warm_new) > budget:
                    raise HbmBudgetExceeded(
                        f"staged bundle is {got} bytes; with the active bundle's {have} bytes + "
                        f"{max(warm, warm_new)} bytes of bucket buffers that exceeds the "
                        f"{budget}-byte device-memory budget")

            return self._stage_and_commit(old_state, stage, kind="swap", check=check_budget)

    def _stage_and_commit(self, old_state, stage, *, kind: str, check=None,
                          drain_timeout_s: float = SWAP_DRAIN_TIMEOUT_S,
                          shards: Tuple[int, int] = (1, 1)) -> Dict[str, object]:
        """The one staging, flip and rollback sequence of a generation
        change (the reference's `_stage_and_commit`); the caller holds
        `mutex`. `stage()` returns the next bundle, staged beside the live
        one (never writing a tensor the live generation reads); then the
        compatibility check (and `check(new_state)`), the pre-warm of every
        bucket program of the new generation (on the card: new CUDA graphs;
        their builds are warmup, not hot-path recompiles), the commit site
        (`swap_commit` for kind "swap", `reshard_commit` for "delta",
        "reshard" and "rebalance": serving/reshard.py's moves, whose
        journal lines carry `shards`, the (old, new) shard counts),
        the atomic flip between batches, the drain of the old generation's
        in-flight batches and its release. Any failure before the flip rolls
        back (counted and journalled by kind) and re-raises: the old
        generation never stopped serving. Kinds "demote" and "restore" (the
        multi-tenant registry's host-tier moves) and "tier_demote" and
        "tier_restore" (its precision-ladder steps), which change the program
        family, skip the compatibility check, fire no commit site and count
        no rollback here (the registry counts a ladder step's). A tenant engine's co-batch captures (its
        `_prewarm_hook`) run after the pre-warm, before the commit; its
        `_retire_hook` gets the state that will never serve again: the
        retired one after the drain, or the staged one on a rollback. Stores
        are closed by identity: a staged bundle's new ones on a rollback,
        the retired bundle's that the new one does not carry after the
        drain."""
        engine = self.engine
        staged = new_state = None
        t0 = time.perf_counter()
        old_stores = {id(s) for s in old_state.bundle.stores()}
        checked = kind in ("swap", *_RESHARD_KINDS)
        try:
            staged = stage()
            t_staged = time.perf_counter()
            new_state = engine._build_state(staged, version=old_state.version + 1)
            if checked:
                self._check_compatible(old_state, new_state, reshard=kind == "reshard")
            if check is not None:
                check(new_state)
            compiles_before = engine.compiles
            engine._warm_state(new_state)
            staging_compiles = engine.compiles - compiles_before
            if engine._prewarm_hook is not None:
                engine._prewarm_hook(new_state)
            t_warm = time.perf_counter()
            if kind == "swap":
                faults.fault_point("swap_commit")
            elif checked:
                faults.fault_point("reshard_commit")
            stage_s = time.perf_counter() - t0
        except BaseException as exc:
            self._roll_back(kind, old_state.version, exc, shards)
            if new_state is not None and engine._retire_hook is not None:
                engine._retire_hook(new_state)
            if staged is not None and staged is not old_state.bundle:
                for store in staged.stores():
                    if id(store) not in old_stores:
                        store.close()
                staged.release(close_stores=False)
            raise
        engine._commit_state(new_state, baseline_bump=staging_compiles)
        if kind == "swap":
            self._swaps += 1
            faults.COUNTERS.increment("serving_swaps")
            telemetry.emit_event("bundle_swap", version=new_state.version, outcome="committed")
        elif kind in _RESHARD_KINDS:
            if kind == "delta":
                self._deltas += 1
            new_state.bundle.provenance["generation"] = new_state.version
            telemetry.emit_event("reshard_commit", old_shards=shards[0], new_shards=shards[1],
                                 version=new_state.version,
                                 restaged_bytes=int(staged.upload_bytes))
        telemetry.METRICS.set_gauge("serving_bundle_generation", new_state.version)
        drained = engine._drain_state(old_state, timeout_s=drain_timeout_s)
        if not drained:
            logger.warning("old bundle version %d still has in-flight batches after %.1fs; "
                           "leaving it allocated", old_state.version, drain_timeout_s)
        else:
            old_state.programs.clear()  # its captured graphs and static buffers
            if engine._retire_hook is not None:
                engine._retire_hook(old_state)
            kept = {id(s) for s in new_state.bundle.stores()}
            for store in old_state.bundle.stores():
                if id(store) not in kept:
                    store.close()
            old_state.bundle.release(close_stores=False)
        flip_s = time.perf_counter() - t0 - stage_s
        logger.info("bundle %s committed: version %d -> %d (staged in %.3fs)", kind,
                    old_state.version, new_state.version, stage_s)
        return {"version": new_state.version, "previous_version": old_state.version,
                "stage_s": stage_s, "staging_compiles": staging_compiles,
                "old_released": drained, "staged_bytes": int(staged.upload_bytes),
                "committed": True, "upload_s": t_staged - t0, "prewarm_s": t_warm - t_staged,
                "flip_s": flip_s}

    def _roll_back(self, kind: str, version: int, exc: BaseException,
                   shards: Tuple[int, int] = (1, 1)) -> None:
        if kind == "swap":
            self._rollbacks += 1
            faults.COUNTERS.increment("serving_swap_rollbacks")
            telemetry.emit_event("bundle_swap", version=version + 1, outcome="rolled_back")
        elif kind == "delta":
            faults.COUNTERS.increment("delta_rollbacks")
            telemetry.emit_event("delta_rollback", version=version, reason=repr(exc))
        elif kind in _RESHARD_KINDS:
            faults.COUNTERS.increment("reshard_rollbacks")
            telemetry.emit_event("reshard_rollback", old_shards=shards[0], new_shards=shards[1],
                                 reason=repr(exc))
        logger.warning("bundle %s to version %d rolled back (%r); version %d keeps serving", kind,
                       version + 1, exc, version)

    @staticmethod
    def _check_compatible(old_state, new_state, *, reshard: bool = False) -> None:
        """The program family keys on coordinate order, kinds, shards and
        feature widths; entity counts may differ. A reshard may change a
        coordinate between replicated and row-sharded ("re" and "re_sh"),
        which is its point, and no other kind."""
        kinds = [(o, n) for o, n in zip(old_state.kinds, new_state.kinds) if o != n]
        moved = reshard and all({o, n} == {"re", "re_sh"} for o, n in kinds)
        if (kinds and not moved) or len(old_state.kinds) != len(new_state.kinds) or \
                [c.cid for c in old_state.coords] != [c.cid for c in new_state.coords]:
            raise SwapIncompatible("next bundle's coordinate ids/kinds differ from the serving engine's")
        if old_state.coord_shards != new_state.coord_shards:
            raise SwapIncompatible("next bundle maps coordinates to different feature shards")
        if old_state.shard_dims != new_state.shard_dims:
            raise SwapIncompatible(f"next bundle's shard dims {new_state.shard_dims} differ from "
                                   f"the engine's {old_state.shard_dims}")
