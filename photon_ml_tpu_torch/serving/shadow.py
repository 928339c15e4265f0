"""Shadow deployment and online evaluation.

Port of `photon_ml_tpu/serving/shadow.py`. A challenger bundle joins the
multi-tenant registry as a shadow tenant and receives a copy of the
champion's traffic, co-batched with the champion (it rides the same
co-batch dispatch, so shadow scoring costs device time, not a second
card). Its answers are never returned: the champion's futures resolve
exactly as they would alone.

Both tenants' scores join the labels by uid into windows, which
`StreamingWindowEvaluator` scores with the offline suite's metric
functions, and every window feeds the score-drift and calibration
histograms. A verdict needs `min_windows` consecutive windows that agree
(all healthy promotes, all regressed rejects; a mixed run holds), after an
optional cooldown; each verdict is journalled with its evidence. Promote
flips the challenger into the champion's engine through
`BundleManager.swap` (stage, pre-warm, commit, drain); reject takes the
shadow tenant away (`TenantRegistry.remove`) without touching the champion.

Fault sites `shadow_mirror`, `label_join` and `shadow_promote`. A mirror or
join failure degrades to champion-only serving (counted, never a failed
request); a failed promotion leaves the champion serving its old generation
bit-equal, since the flip is the swap's atomic commit. Callers wait on
`drain()` and `wait_for_verdict()`, which block on the controller's
condition and event, not on a clock.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.contracts import SHADOW_BLOCK_KEYS
from photon_ml_tpu_torch.evaluation.suite import (
    EvaluatorType,
    StreamingWindowEvaluator,
    default_evaluator_for_task,
    regression,
)
from photon_ml_tpu_torch.serving.bundle import ScoreRequest
from photon_ml_tpu_torch.serving.engine import ScoreResult
from photon_ml_tpu_torch.serving.tenancy import TenantRegistry
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

# One joined row: champion score and mean, challenger score and mean, label,
# weight. The scores feed the metrics (what offline evaluation scores), the
# means the drift and calibration histograms.
_Row = Tuple[float, float, float, float, float, float]


class ShadowController:
    """Mirror champion traffic to a shadow challenger, evaluate both online,
    and promote or reject without touching the champion's answers.

    The controller owns the challenger: it admits the bundle as a shadow
    tenant at construction and removes it (releasing the bundle) on a
    reject, a failed promotion, or `close()` before a verdict; a promotion
    hands the bundle to the champion's engine. With `auto_actuate=False`
    (the refresh gate, cli/refresh.py) a promote verdict is recorded for
    `wait_for_verdict()` and the caller acts; a reject always removes the
    shadow. Parameters left None read PHOTON_SHADOW_MIN_WINDOWS,
    PHOTON_SHADOW_REGRESSION_TOL, PHOTON_SHADOW_COOLDOWN_S and
    PHOTON_SHADOW_MIRROR_FRACTION."""

    def __init__(self, registry: TenantRegistry, champion: str, challenger: str, challenger_bundle,
                 *, evaluator_types: Optional[Sequence[EvaluatorType]] = None,
                 window_size: int = 64, min_windows: Optional[int] = None,
                 regression_tol: Optional[float] = None, cooldown_s: Optional[float] = None,
                 mirror_fraction: Optional[float] = None, auto_actuate: bool = True,
                 max_pending_joins: int = 4096, max_pending: Optional[int] = None,
                 deadline_ms: Optional[float] = None):
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
        self._registry = registry
        self._champion = champion
        self._challenger = challenger
        self._window_size = int(window_size)
        self._min_windows = int(get_knob("PHOTON_SHADOW_MIN_WINDOWS") if min_windows is None
                                else min_windows)
        self._regression_tol = float(get_knob("PHOTON_SHADOW_REGRESSION_TOL")
                                     if regression_tol is None else regression_tol)
        self._cooldown_s = float(get_knob("PHOTON_SHADOW_COOLDOWN_S") if cooldown_s is None
                                 else cooldown_s)
        self._mirror_fraction = float(get_knob("PHOTON_SHADOW_MIRROR_FRACTION")
                                      if mirror_fraction is None else mirror_fraction)
        if self._min_windows < 1:
            raise ValueError(f"min_windows must be >= 1, got {self._min_windows}")
        if not 0.0 < self._mirror_fraction <= 1.0:
            raise ValueError(f"mirror_fraction must be in (0, 1], got {self._mirror_fraction}")
        self._auto_actuate = bool(auto_actuate)
        self._max_pending_joins = int(max_pending_joins)
        champ_engine = registry.tenant(champion).engine
        self._device = champ_engine.device
        ets = list(evaluator_types) if evaluator_types else [default_evaluator_for_task(champ_engine.task)]
        self._evaluator = StreamingWindowEvaluator(ets)

        # Join state, guarded by _cond. Callbacks (on the registry's and the
        # batchers' threads) touch only these; device work runs on the worker.
        self._cond = threading.Condition()
        self._pending: Dict[str, Dict[str, Optional[ScoreResult]]] = {}
        self._labels: Dict[str, Tuple[float, float]] = {}
        self._rows: Deque[_Row] = collections.deque()
        self._evaluating = False
        self._history: List[bool] = []
        self._last_metrics: Tuple[Optional[float], Optional[float]] = (None, None)
        self._credit = 0.0
        self._mirrored = 0
        self._mirror_failures = 0
        self._label_join_failures = 0
        self._status = "observing"
        self._verdict: Optional[str] = None
        self._verdict_event = threading.Event()
        self._closed = False
        self._error: Optional[BaseException] = None
        self._started = time.monotonic()

        # Same signature as the champion (entity counts are not in it), so
        # mirrored traffic rides the champion's co-batch.
        registry.admit(challenger, challenger_bundle, max_pending=max_pending,
                       deadline_ms=deadline_ms)
        telemetry.emit_event("shadow_start", champion=champion, challenger=challenger,
                             window_size=self._window_size, min_windows=self._min_windows,
                             mirror_fraction=self._mirror_fraction)
        self._worker = threading.Thread(target=self._run, name=f"photon-shadow-{challenger}-eval",
                                        daemon=True)
        self._worker.start()

    # ---------------------------------------------------------- mirroring

    @property
    def status(self) -> str:
        with self._cond:
            return self._status

    @property
    def verdict(self) -> Optional[str]:
        with self._cond:
            return self._verdict

    def mirror(self, request: ScoreRequest, champion_future: "Future[ScoreResult]") -> bool:
        """Mirror one champion request to the challenger. False means
        champion-only (no uid to join on, the fraction gate, a mirror fault,
        the shadow's quota, or a controller past observing), never an error:
        the champion's future is not touched either way."""
        uid = request.uid
        if uid is None:
            return False
        with self._cond:
            if self._status != "observing" or self._closed:
                return False
            # A deterministic credit: at fraction f, every (1/f)th request.
            self._credit += self._mirror_fraction
            if self._credit < 1.0:
                return False
            self._credit -= 1.0
            self._pending[uid] = {"champion": None, "challenger": None}
            self._evict_stale_joins_locked()
        try:
            faults.fault_point("shadow_mirror")
            shadow_future = self._registry.submit(self._challenger, request, block=False)
        except BaseException as exc:  # degrade, never fail
            with self._cond:
                self._pending.pop(uid, None)
                self._mirror_failures += 1
            faults.COUNTERS.increment("shadow_mirror_failures")
            logger.warning("shadow mirror for %r degraded to champion-only: %s", uid, exc)
            return False
        telemetry.METRICS.increment("shadow_mirrored_requests")
        with self._cond:
            self._mirrored += 1
        champion_future.add_done_callback(lambda f, _u=uid: self._on_result("champion", _u, f))
        shadow_future.add_done_callback(lambda f, _u=uid: self._on_result("challenger", _u, f))
        return True

    def record_label(self, uid: str, label: float, weight: float = 1.0) -> bool:
        """Join one label into the evaluation stream. A `label_join` fault
        drops the label (counted); the champion path never sees labels."""
        try:
            faults.fault_point("label_join")
        except faults.InjectedFault as exc:
            with self._cond:
                self._label_join_failures += 1
            faults.COUNTERS.increment("label_join_failures")
            logger.warning("label join for %r dropped: %s", uid, exc)
            return False
        with self._cond:
            if self._closed:
                return False
            self._labels[uid] = (float(label), float(weight))
            self._maybe_complete_locked(uid)
            # An unmatched label may not grow memory forever: dropping one
            # is a failed join.
            while len(self._labels) > self._max_pending_joins:
                del self._labels[next(iter(self._labels))]
                self._label_join_failures += 1
                faults.COUNTERS.increment("label_join_failures")
        return True

    def _on_result(self, role: str, uid: str, fut: Future) -> None:
        try:
            exc = fut.exception()
        except BaseException as cancelled:  # a cancelled future
            exc = cancelled
        if exc is not None:
            # A failed champion request evaluates nothing; a failed mirrored
            # request is a mirror failure.
            with self._cond:
                dropped = self._pending.pop(uid, None) is not None
                if dropped and role == "challenger":
                    self._mirror_failures += 1
                self._cond.notify_all()
            if dropped and role == "challenger":
                faults.COUNTERS.increment("shadow_mirror_failures")
            return
        result = fut.result()
        with self._cond:
            ent = self._pending.get(uid)
            if ent is None:
                return
            ent[role] = result
            self._maybe_complete_locked(uid)
            self._cond.notify_all()  # a drain may be waiting on this pair

    def _maybe_complete_locked(self, uid: str) -> None:
        ent = self._pending.get(uid)
        if ent is None or ent["champion"] is None or ent["challenger"] is None:
            return
        lab = self._labels.get(uid)
        if lab is None:
            return
        champ, chall = ent["champion"], ent["challenger"]
        del self._pending[uid]
        del self._labels[uid]
        self._rows.append((champ.score, champ.mean, chall.score, chall.mean, lab[0], lab[1]))
        self._cond.notify_all()

    def _evict_stale_joins_locked(self) -> None:
        # A pair whose label (or score) never arrives is a failed join.
        while len(self._pending) > self._max_pending_joins:
            stale = next(iter(self._pending))
            del self._pending[stale]
            self._labels.pop(stale, None)
            self._label_join_failures += 1
            faults.COUNTERS.increment("label_join_failures")

    # ------------------------------------------------------ decision loop

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    while (not self._closed and self._status == "observing"
                           and len(self._rows) < self._window_size):
                        self._cond.wait()
                    if self._closed or self._status != "observing":
                        return
                    rows = [self._rows.popleft() for _ in range(self._window_size)]
                    self._evaluating = True
                try:
                    self._evaluate_window(rows)
                finally:
                    with self._cond:
                        self._evaluating = False
                        self._cond.notify_all()
        except BaseException as exc:  # surfaced by drain/wait_for_verdict
            logger.exception("shadow decision worker died")
            with self._cond:
                self._error = exc
                self._cond.notify_all()
            self._verdict_event.set()

    def _evaluate_window(self, rows: Sequence[_Row]) -> None:
        arr = np.asarray(rows, np.float32)
        c_means, s_means, labels = arr[:, 1], arr[:, 3], arr[:, 4]
        window = torch.from_numpy(arr).to(self._device)
        c_scores, s_scores, lab, wt = window[:, 0], window[:, 2], window[:, 4], window[:, 5]
        c_val = self._evaluator.evaluate_window(c_scores, lab, wt).primary_value
        s_val = self._evaluator.evaluate_window(s_scores, lab, wt).primary_value
        for cm, sm, lb in zip(c_means, s_means, labels):
            telemetry.METRICS.observe("shadow_score_drift", abs(float(cm) - float(sm)))
            telemetry.METRICS.observe("shadow_calibration_champion", abs(float(cm) - float(lb)))
            telemetry.METRICS.observe("shadow_calibration_challenger", abs(float(sm) - float(lb)))
        telemetry.METRICS.increment("shadow_windows")
        healthy = regression(self._evaluator.primary, s_val, c_val) <= self._regression_tol
        with self._cond:
            self._history.append(healthy)
            self._last_metrics = (c_val, s_val)
            window_index = len(self._history)
        telemetry.emit_event("shadow_window", champion=self._champion, challenger=self._challenger,
                             window=window_index, rows=len(rows), champion_metric=c_val,
                             challenger_metric=s_val, evaluator=str(self._evaluator.primary),
                             healthy=healthy)
        decision = self._check_verdict()
        if decision is None:
            return
        with self._cond:
            self._verdict = decision
        telemetry.emit_event(
            "shadow_verdict", champion=self._champion, challenger=self._challenger,
            decision=decision, windows=window_index, champion_metric=c_val,
            challenger_metric=s_val, evaluator=str(self._evaluator.primary),
            reason=(f"last {self._min_windows} window(s) all "
                    f"{'healthy' if decision == 'promote' else 'regressed'} "
                    f"(tol={self._regression_tol}, evaluator={self._evaluator.primary})"))
        if decision == "reject":
            # A regressed challenger never keeps riding the card.
            self._teardown_rejected(f"regression verdict after {window_index} window(s)")
        elif self._auto_actuate:
            self.promote(raise_on_failure=False)
        else:
            with self._cond:
                self._status = "promote_ready"
        self._verdict_event.set()
        with self._cond:
            self._cond.notify_all()

    def _check_verdict(self) -> Optional[str]:
        with self._cond:
            if self._cooldown_s > 0.0 and time.monotonic() - self._started < self._cooldown_s:
                return None
            if len(self._history) < self._min_windows:
                return None
            recent = self._history[-self._min_windows:]
        if all(recent):
            return "promote"
        if not any(recent):
            return "reject"
        return None  # mixed evidence: the hysteresis band holds

    def drain(self, timeout_s: float = 60.0) -> Optional[str]:
        """Wait (at most `timeout_s`) until every mirrored pair still in
        flight has both its answers, and the worker has evaluated every
        full window joined and, when that gives a verdict, acted on it.
        Returns the verdict, or None when the backlog ran out without one.
        A challenger's answers can come after all of the champion's (its
        batches lag under load), so the joins are waited for first; the
        reference's drain looks at the joined rows alone and can snapshot
        before the last windows join."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while not self._verdict_event.is_set() and self._error is None:
                if not self._evaluating and (self._closed or self._status != "observing"
                                             or (len(self._rows) < self._window_size
                                                 and not self._joins_in_flight_locked())):
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            if self._error is not None:
                raise RuntimeError("shadow decision worker died") from self._error
            return self._verdict

    def _joins_in_flight_locked(self) -> bool:
        """True while a mirrored pair waits for an answer (a pair with both
        answers and no label is not in flight: its label may never come)."""
        return any(e["champion"] is None or e["challenger"] is None for e in self._pending.values())

    def wait_for_verdict(self, timeout_s: Optional[float] = None) -> Optional[str]:
        """Block until a verdict fires (or the worker dies); the decision,
        or None on timeout."""
        self._verdict_event.wait(timeout=timeout_s)
        with self._cond:
            if self._error is not None:
                raise RuntimeError("shadow decision worker died") from self._error
            return self._verdict

    # ----------------------------------------------------------- actuators

    def promote(self, *, raise_on_failure: bool = True) -> Optional[Dict[str, object]]:
        """Flip the challenger to champion: retire the shadow tenant (its
        mirrored work drains; its bundle stays staged), then swap that bundle
        into the champion's engine through the generation flip. Any failure,
        an armed `shadow_promote` fault past its retries included, leaves the
        champion serving its old generation and takes the challenger away
        (a rollback, counted and journalled)."""
        with self._cond:
            if self._status not in ("observing", "promote_ready"):
                raise RuntimeError(f"cannot promote from status {self._status!r}")
            self._status = "promoting"
        champ_engine = self._registry.tenant(self._champion).engine
        chall_bundle = self._registry.tenant(self._challenger).engine._state.bundle
        try:
            self._registry.remove(self._challenger, release_bundle=False)
            faults.retry(lambda: faults.fault_point("shadow_promote"), label="shadow promotion")
            info = champ_engine.bundle_manager.swap(chall_bundle)
        except BaseException as exc:  # the champion keeps serving
            if not chall_bundle.released:
                chall_bundle.release()
            faults.COUNTERS.increment("shadow_rollbacks")
            telemetry.emit_event("shadow_rollback", champion=self._champion,
                                 challenger=self._challenger, reason=f"promotion failed: {exc}")
            with self._cond:
                self._status = "rejected"
            logger.warning("shadow promotion of %r failed; champion %r keeps serving its old "
                           "generation: %s", self._challenger, self._champion, exc)
            if raise_on_failure:
                raise
            return None
        telemetry.METRICS.increment("shadow_promotions")
        telemetry.emit_event("shadow_promote", champion=self._champion, challenger=self._challenger,
                             version=info["version"])
        with self._cond:
            self._status = "promoted"
        logger.info("shadow challenger %r promoted to champion %r (generation %s)", self._challenger,
                    self._champion, info["version"])
        return info

    def _teardown_rejected(self, reason: str) -> None:
        try:
            self._registry.remove(self._challenger, release_bundle=True)
        except KeyError:
            pass  # already retired
        faults.COUNTERS.increment("shadow_rollbacks")
        telemetry.emit_event("shadow_rollback", champion=self._champion, challenger=self._challenger,
                             reason=reason)
        with self._cond:
            self._status = "rejected"
        logger.info("shadow challenger %r rejected and removed (%s); champion %r unaffected",
                    self._challenger, reason, self._champion)

    # ------------------------------------------------------------ lifecycle

    def summary(self) -> Dict[str, object]:
        """The serving summary's shadow block (SHADOW_BLOCK_KEYS)."""
        champ_engine = self._registry.tenant(self._champion).engine
        drift = telemetry.METRICS.histogram("shadow_score_drift")
        with self._cond:
            c_val, s_val = self._last_metrics
            block = dict(zip(SHADOW_BLOCK_KEYS, (
                self._champion, self._challenger, self._status, len(self._history), self._mirrored,
                self._mirror_failures, self._label_join_failures, c_val, s_val,
                str(self._evaluator.primary), None if drift is None else drift.quantile(0.5),
                int(champ_engine._state.version))))
        return block

    def close(self) -> None:
        """Stop the decision loop and remove a shadow tenant still admitted,
        without a verdict (no rollback counted, no verdict journalled).
        Idempotent; joins the worker."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=30.0)
        try:
            self._registry.remove(self._challenger, release_bundle=True)
        except KeyError:
            pass  # retired by a verdict
        with self._cond:
            if self._status == "observing":
                self._status = "closed"

    def __enter__(self) -> "ShadowController":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
