"""Hang watchdog: a deadline armed around device dispatches.

Port of `photon_ml_tpu/utils/watchdog.py`. `Watchdog.guard(deadline_ms,
label)` arms a deadline on one monitor thread (`photon-watchdog`, started
on the first armed guard and joined by `close()`):

  * a scope that ends before its deadline costs two lock hops;
  * when the deadline passes first, the monitor trips at once: it counts
    `COUNTERS["watchdog_trips"]`, journals `watchdog_trip` and calls
    `on_trip`, so a dispatch that is still stuck already marks its engine
    degraded;
  * when the scope does end, a tripped guard raises `faults.DeviceHang`
    and the late result is discarded.

`PHOTON_WATCHDOG_MS` sets the serving engine's deadline; 0 (the default)
keeps `guard()` free and starts no thread.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional, Tuple

from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)


def watchdog_ms() -> float:
    """The dispatch deadline PHOTON_WATCHDOG_MS sets; <= 0 is off."""
    return float(int(get_knob("PHOTON_WATCHDOG_MS")))


class Watchdog:
    """One monitor thread arming deadlines over concurrent guarded scopes."""

    def __init__(self, on_trip: Optional[Callable[[str], None]] = None):
        self._on_trip = on_trip
        self._cv = threading.Condition()
        # guard id -> (deadline, label, [tripped], the arming thread's metric
        # labels: the trip is counted on the monitor thread)
        self._armed: Dict[int, Tuple[float, str, list, object]] = {}
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.trips = 0

    def _ensure_thread_locked(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._monitor, name="photon-watchdog", daemon=True)
            self._thread.start()

    def _monitor(self) -> None:
        with self._cv:
            while not self._closed:
                pending = [d for d, _, flag, _ in self._armed.values() if not flag[0]]
                if not pending:
                    self._cv.wait()  # idle, or every armed guard already tripped
                    continue
                now = time.monotonic()
                if now < min(pending):
                    self._cv.wait(timeout=min(pending) - now)
                    continue
                tripped = [(label, flag, mlabels) for d, label, flag, mlabels in self._armed.values()
                           if d <= now and not flag[0]]
                for label, flag, mlabels in tripped:
                    flag[0] = True
                    self.trips += 1
                    faults.COUNTERS.increment("watchdog_trips", labels=mlabels)
                    telemetry.emit_event("watchdog_trip", label=label)
                    logger.warning("watchdog tripped: %s exceeded its deadline (dispatch still "
                                   "in flight)", label)
                if tripped and self._on_trip is not None:
                    # The callbacks run with the condition released: one that
                    # takes engine locks must not deadlock against a thread
                    # arming a guard.
                    self._cv.release()
                    try:
                        for label, _, _ in tripped:
                            try:
                                self._on_trip(label)
                            except Exception:  # a failed callback must not stop the monitor
                                logger.exception("watchdog on_trip failed")
                    finally:
                        self._cv.acquire()

    @contextmanager
    def guard(self, deadline_ms: float, label: str):
        """Arm `deadline_ms` around the scope; raise DeviceHang at its end if
        the deadline passed first. `deadline_ms <= 0` is a free no-op."""
        if deadline_ms is None or deadline_ms <= 0:
            yield
            return
        flag = [False]
        gid = None
        with self._cv:
            if not self._closed:
                gid = next(self._ids)
                self._armed[gid] = (time.monotonic() + deadline_ms / 1e3, label, flag,
                                    telemetry.current_metric_labels())
                self._ensure_thread_locked()
                self._cv.notify_all()
        try:
            yield
        finally:
            if gid is not None:
                with self._cv:
                    self._armed.pop(gid, None)
                    self._cv.notify_all()
        if flag[0]:
            raise faults.DeviceHang(f"{label}: device dispatch exceeded the {deadline_ms:.0f} ms "
                                    "watchdog deadline; result discarded")

    def close(self) -> None:
        """Stop and join the monitor thread (idempotent)."""
        with self._cv:
            self._closed = True
            thread = self._thread
            self._cv.notify_all()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=10)

    def __enter__(self) -> "Watchdog":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
