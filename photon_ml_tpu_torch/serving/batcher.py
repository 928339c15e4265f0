"""Deadline micro-batching: coalesce single requests into engine batches.

Port of `photon_ml_tpu/serving/batcher.py`. The flush thread claims a
batch when `max_batch` requests wait or the oldest has waited
`max_wait_ms` (the planner's `serving_max_wait_ms`: 2.0 ms with no plan
installed).

* Admission: the pending queue holds at most `max_pending` requests; a
  submit against a full queue is shed with `Overloaded` (`block=True`
  waits for room instead). The `admit` fault site fires once per submit.
* Deadlines: a request still queued past its budget (its own
  `deadline_ms`, else `default_deadline_ms`) fails with `DeadlineExceeded`
  when a batch is assembled, before it takes a slot; the check subtracts a
  decaying maximum of recent batch service times, so an answer that could
  only arrive late is refused up front.
* Circuit routing: while the engine's breaker is open, batches are
  answered by the fixed-effect-only tier.
* Degradation: any failed batch is dispatched again request by request
  (transient failures retried; a request that fails on its own fails only
  its future). The bucket programs are batch-size invariant, so those
  answers have the batch's bits. A watchdog trip answers the whole batch
  FE-only.
* Flush-thread death: pending futures fail with the error, later submits
  raise `BatcherUnhealthy`, the engine stays DEGRADED, and `close()` still
  joins.

The flush thread is `photon-serving-flush` (or `thread_name`, such as a
tenant's `photon-tenant-<name>-flush`); `close()` (or the engine's) answers
what is pending and joins it. `metric_labels` (a tenant's {"tenant":
name}) label every robustness counter the batcher bumps and everything its
flush thread fires, so each tenant's counts are its own sub-counts beside
the process-wide totals. The `admit` site is behind the engine's
`inject_faults` gate.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from concurrent.futures import Future
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from photon_ml_tpu_torch.serving.bundle import ScoreRequest
from photon_ml_tpu_torch.serving.engine import ScoreResult, ServingEngine
from photon_ml_tpu_torch.serving.lifecycle import BatcherUnhealthy, DeadlineExceeded, Overloaded
from photon_ml_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)

# One queued request: (request, future, submit time, absolute expiry or None).
_Pending = Tuple[ScoreRequest, Future, float, Optional[float]]


class MicroBatcher:
    """A bounded queue and a flush thread in front of a ServingEngine.
    `submit()` returns a Future[ScoreResult]; `score()` blocks. Close it (or
    use it as a context manager): pending requests are still answered."""

    def __init__(self, engine: ServingEngine, *, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None, max_pending: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None, thread_name: Optional[str] = None,
                 metric_labels: Optional[Dict[str, str]] = None):
        # A planned quantity: an explicit argument wins, else the installed
        # plan's serving_max_wait_ms, else the default.
        if max_wait_ms is None:
            from photon_ml_tpu_torch import planner

            max_wait_ms = float(planner.planned_value("serving_max_wait_ms"))
        self.engine = engine
        self.max_batch = int(engine.max_batch if max_batch is None else max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_batch > engine.max_batch:
            raise ValueError(f"max_batch {self.max_batch} exceeds the engine's declared bucket "
                             f"ceiling {engine.max_batch}")
        # A few batches deep by default: rides a burst, sheds a backlog.
        self.max_pending = int(max(4 * self.max_batch, 64) if max_pending is None else max_pending)
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        self.default_deadline_ms = None if default_deadline_ms is None else float(default_deadline_ms)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._pending: Deque[_Pending] = collections.deque()
        self._cv = threading.Condition()
        self._stop = False
        self._unhealthy: Optional[BaseException] = None
        self._latency = telemetry.LatencyStats()
        self._batch_sizes = telemetry.LatencyStats()
        self._completed = 0
        self._failed = 0
        self._shed = 0
        self._deadline_missed = 0
        # A decaying maximum of batch service time (claim -> answers): the
        # deadline check is about the admitted tail.
        self._service_tail_s = 0.0
        self._fe_only = 0
        self._degraded = 0
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self._metric_labels = (tuple(sorted((k, str(v)) for k, v in metric_labels.items()))
                               if metric_labels else None)
        self._thread = threading.Thread(target=self._flush_loop,
                                        name=thread_name or "photon-serving-flush", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ lifecycle

    @property
    def closed(self) -> bool:
        return self._stop

    @property
    def healthy(self) -> bool:
        return self._unhealthy is None

    def close(self) -> None:
        """Answer what is pending, stop and join the flush thread."""
        with self._cv:
            if self._stop:
                return
            self._stop = True
            self._cv.notify_all()
        self._thread.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -------------------------------------------------------------- scoring

    def submit(self, request: ScoreRequest, *, block: bool = False,
               deadline_ms: Optional[float] = None) -> "Future[ScoreResult]":
        """Enqueue one request. Raises `Overloaded` when the queue is full
        (`block=True` waits instead), `BatcherUnhealthy` after a flush-thread
        death, RuntimeError after close. `deadline_ms` overrides the
        request's budget and the default."""
        fut: "Future[ScoreResult]" = Future()
        now = time.monotonic()
        budget_ms = deadline_ms if deadline_ms is not None else (
            request.deadline_ms if request.deadline_ms is not None else self.default_deadline_ms)
        expiry = None if budget_ms is None else now + budget_ms / 1e3
        with self._cv:
            first_pass = True
            while True:
                if self._stop:
                    raise RuntimeError("MicroBatcher is closed")
                if self._unhealthy is not None:
                    raise BatcherUnhealthy(f"flush thread died: {self._unhealthy!r}") from self._unhealthy
                if first_pass:
                    # After the closed/unhealthy checks, once per submit.
                    first_pass = False
                    try:
                        if self.engine.inject_faults:
                            faults.fault_point("admit")
                    except faults.InjectedFault as exc:
                        self._shed += 1
                        faults.COUNTERS.increment("serving_shed_requests", labels=self._metric_labels)
                        raise Overloaded(f"admission fault injected: {exc}") from exc
                if len(self._pending) < self.max_pending:
                    break
                if not block:
                    self._shed += 1
                    faults.COUNTERS.increment("serving_shed_requests", labels=self._metric_labels)
                    raise Overloaded(f"pending queue full ({self.max_pending} requests); shed by "
                                     "admission control")
                self._cv.wait()
            if self._t_first_submit is None:
                self._t_first_submit = now
            self._pending.append((request, fut, now, expiry))
            self._cv.notify_all()
        return fut

    def score_all(self, requests: Iterable[ScoreRequest]) -> List[ScoreResult]:
        """Submit a stream (backpressured, never shed) and wait for every
        result, in order."""
        futures = [self.submit(r, block=True) for r in requests]
        return [f.result() for f in futures]

    # ----------------------------------------------------------- flush loop

    def _flush_loop(self) -> None:
        try:
            if self._metric_labels is not None:
                # For the thread's life: what the dispatch path fires from
                # here (a watchdog trip too) lands in the labels' sub-counts.
                with telemetry.metric_label_scope(**dict(self._metric_labels)):
                    self._flush_loop_inner()
            else:
                self._flush_loop_inner()
        except BaseException as exc:  # the thread's last guard: fail what is pending
            self._die(exc)
            with self._cv:
                doomed = list(self._pending)
                self._pending.clear()
                self._failed += len(doomed)
            for _, fut, _, _ in doomed:
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(exc)

    def _die(self, exc: BaseException) -> None:
        """Mark the batcher unhealthy and the engine degraded, once, before
        any future is failed: a client that sees its request fail already
        sees the death."""
        with self._cv:
            if self._unhealthy is not None:
                return
            self._unhealthy = exc
            self._cv.notify_all()  # wake blocked submitters
        logger.error("serving flush thread died: %r", exc)
        faults.COUNTERS.increment("serving_flush_thread_failures", labels=self._metric_labels)
        self.engine._on_batcher_unhealthy(exc)

    def _flush_loop_inner(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._ripe_locked():
                    self._cv.wait(timeout=self._wait_timeout_locked())
                if self._stop and not self._pending:
                    return
                # Each future turns RUNNING as it is claimed (a cancelled one
                # is dropped here, so completing it later cannot race a
                # cancel); an expired request fails here, never co-batched.
                batch: List[_Pending] = []
                expired: List[Future] = []
                now = time.monotonic()
                horizon = now + self._service_tail_s  # when the answers would land
                while len(batch) < self.max_batch and self._pending:
                    item = self._pending.popleft()
                    if item[3] is not None and horizon >= item[3]:
                        if item[1].set_running_or_notify_cancel():
                            expired.append(item[1])
                        continue
                    if item[1].set_running_or_notify_cancel():
                        batch.append(item)
                telemetry.METRICS.set_gauge("serving_pending_depth", len(self._pending))
                if expired:
                    self._deadline_missed += len(expired)
                    self._failed += len(expired)
                    if not batch:
                        # Nothing dispatched, so nothing re-measures the
                        # service time: decay it, or a spike would pre-fail
                        # every short-budget request forever.
                        self._service_tail_s *= 0.5
                self._cv.notify_all()  # room in the queue: wake submitters
            for fut in expired:
                faults.COUNTERS.increment("serving_deadline_misses", labels=self._metric_labels)
                fut.set_exception(DeadlineExceeded("request expired in queue before batch assembly"))
            if batch:
                try:
                    self._dispatch(batch)
                except BaseException as exc:
                    # The claimed batch left the queue: fail its futures here,
                    # after the death is recorded.
                    self._die(exc)
                    with self._cv:
                        self._failed += sum(1 for _, f, _, _ in batch if not f.done())
                    for _, fut, _, _ in batch:
                        if not fut.done():
                            fut.set_exception(exc)
                    raise

    def _ripe_locked(self) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        front = self._pending[0]
        now = time.monotonic()
        if front[3] is not None and now >= front[3]:
            return True  # an expired head: claim it to fail it promptly
        return (now - front[2]) >= self.max_wait_s

    def _wait_timeout_locked(self) -> Optional[float]:
        if not self._pending:
            return None
        front = self._pending[0]
        wake = front[2] + self.max_wait_s
        if front[3] is not None:
            wake = min(wake, front[3])
        return max(0.0, wake - time.monotonic())

    def _update_service_tail(self, wall_s: float) -> None:
        with self._cv:
            self._service_tail_s = max(wall_s, 0.9 * self._service_tail_s)

    def _dispatch(self, batch: List[_Pending]) -> None:
        now = time.monotonic()
        waits_ms = [(now - t0) * 1e3 for _, _, t0, _ in batch]
        for w in waits_ms:
            telemetry.METRICS.observe("serving_queue_wait_ms", w)
        telemetry.METRICS.observe("serving_batch_size", len(batch))
        self._batch_sizes.record(float(len(batch)))
        budgets = [(e - now) * 1e3 for _, _, _, e in batch if e is not None]
        with telemetry.span("serving_batch", size=len(batch), queue_wait_ms_max=max(waits_ms),
                            deadline_budget_ms_min=min(budgets) if budgets else None):
            self._dispatch_batch(batch)

    def _dispatch_batch(self, batch: List[_Pending]) -> None:
        requests = [r for r, _, _, _ in batch]
        t_d = time.monotonic()
        breaker = self.engine.breaker
        permit = breaker.acquire()
        if permit is None:
            self._dispatch_fe_only(batch)  # circuit open: answers, not errors
            return
        try:
            results = self.engine.score_batch(requests)
        except faults.DeviceHang:
            # A watchdog trip is device evidence: feed the breaker and answer
            # the whole batch FE-only (re-probing a wedged device once per
            # request would stall the queue).
            breaker.on_failure(permit)
            faults.COUNTERS.increment("serving_degraded_batches", labels=self._metric_labels)
            with self._cv:
                self._degraded += 1
            logger.warning("batch of %d hit the dispatch watchdog; answering FE-only", len(requests))
            self._dispatch_fe_only(batch)
            return
        except BaseException as exc:  # judged request by request below
            # One bad request fails a pack as a device blip fails a
            # dispatch: return the permit and dispatch each request alone.
            breaker.on_abandon(permit)
            faults.COUNTERS.increment("serving_degraded_batches", labels=self._metric_labels)
            with self._cv:
                self._degraded += 1
            logger.warning("batch of %d degraded to per-request dispatch: %s", len(requests), exc)
            self._dispatch_degraded(batch)
            return
        breaker.on_success(permit)
        now = time.monotonic()
        self._update_service_tail(now - t_d)
        for (_, fut, t0, _), res in zip(batch, results):
            self._complete(fut, res, now - t0)

    def _dispatch_degraded(self, batch: List[_Pending]) -> None:
        breaker = self.engine.breaker
        for req, fut, t0, _ in batch:
            permit = breaker.acquire()
            if permit is None:
                # The circuit opened mid-loop: FE-only answers for the rest.
                self._dispatch_fe_only([(req, fut, t0, None)])
                continue
            try:
                res = faults.retry(lambda req=req: self.engine.score_batch([req])[0],
                                   label="serving per-request fallback")
            except BaseException as exc:  # surfaced through the future
                if faults.is_device_error(exc):
                    breaker.on_failure(permit)
                else:
                    breaker.on_abandon(permit)  # the request's fault, not the device's
                if isinstance(exc, faults.DeviceHang):
                    # A hang that outlived its retries still answers, FE-only.
                    self._dispatch_fe_only([(req, fut, t0, None)])
                    continue
                with self._cv:
                    self._failed += 1
                fut.set_exception(exc)
                continue
            breaker.on_success(permit)
            self._complete(fut, res, time.monotonic() - t0)

    def _dispatch_fe_only(self, batch: List[_Pending]) -> None:
        """The circuit-open tier (no fault site fires on it)."""
        requests = [r for r, _, _, _ in batch]
        try:
            results = self.engine.score_batch_fe_only(requests)
        except BaseException as exc:  # surfaced through the futures
            logger.error("FE-only degradation tier failed: %r", exc)
            with self._cv:
                self._failed += len(batch)
            for _, fut, _, _ in batch:
                fut.set_exception(exc)
            return
        with self._cv:
            self._fe_only += len(batch)
        faults.COUNTERS.increment("serving_fe_only_requests", len(batch), labels=self._metric_labels)
        now = time.monotonic()
        for (_, fut, t0, _), res in zip(batch, results):
            self._complete(fut, res, now - t0)

    def _complete(self, fut: Future, res: ScoreResult, wall_s: float) -> None:
        self._latency.record(wall_s * 1e3)
        telemetry.METRICS.observe("serving_latency_ms", wall_s * 1e3)
        with self._cv:
            self._completed += 1
            self._t_last_done = time.monotonic()
        fut.set_result(res)

    # -------------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, object]:
        """Latency percentiles, qps, admission/deadline/circuit accounting
        and the engine's counters, in one snapshot."""
        with self._cv:
            completed, failed = self._completed, self._failed
            out: Dict[str, object] = {
                "completed": completed, "failed": failed, "degraded_batches": self._degraded,
                "shed": self._shed, "deadline_missed": self._deadline_missed,
                "fe_only_answers": self._fe_only, "max_pending": self.max_pending,
                "unhealthy": None if self._unhealthy is None else repr(self._unhealthy),
            }
            t0, t1 = self._t_first_submit, self._t_last_done
        for q in (50, 95, 99):
            out[f"p{q}_ms"] = self._latency.percentile(float(q)) if self._latency.count else None
        out["batch_size_p50"] = self._batch_sizes.percentile(50.0) if self._batch_sizes.count else None
        out["batch_size_p95"] = self._batch_sizes.percentile(95.0) if self._batch_sizes.count else None
        wall = (t1 - t0) if (t0 is not None and t1 is not None and t1 > t0) else 0.0
        out["qps"] = completed / wall if wall > 0 else None
        out.update(self.engine.metrics())
        return out
