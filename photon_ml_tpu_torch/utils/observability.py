"""The drivers' observability: timed sections and the job log file.

Port of the part of `photon_ml_tpu/utils/observability.py` the drivers use:

  * `TimingRegistry`: the job's (section -> seconds) totals and call
    counts, a `timing.StageTimes` with a printable summary.
  * `Timed`: `with Timed("read data", registry=r, device=dev):` logs the
    section's wall clock, records it and opens a trace span of the same
    name; on a CUDA device the clock stops, and the span closes, after
    `torch.cuda.synchronize`, so a section owns the device work it queued
    (photon-lib util/Timed.scala:33-60).
  * `PhotonLogger`: the job log file (photon-lib util/PhotonLogger.scala:
    34-120), a handler on the package logger for the job's lifetime.
  * `stage_scope` / `stage_timer`: a thread's ambient stage registry and
    a timed block recorded into it (and opened as a trace span): the
    serving engine's `serve_pack`, `serve_lookup` and `serve_score`.

  * `EventEmitter` / `Event` and its subclasses: the synchronous
    lifecycle bus (photon-client event/EventEmitter.scala:24,
    Event.scala:28); `journal_listener` writes each event as its typed line
    of a `telemetry.RunJournal`.

The run journal, tracer and run profile themselves are in
`utils/telemetry.py`.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from contextlib import ContextDecorator, contextmanager
from typing import Callable, Dict, List, Optional

import torch

from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.utils import telemetry

logger = logging.getLogger("photon_ml_tpu_torch")

_LEVELS = {
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARN": logging.WARNING,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "CRITICAL": logging.CRITICAL,
    "FATAL": logging.CRITICAL,
}


class TimingRegistry(StageTimes):
    """Accumulates (section -> seconds) and call counts across a job."""

    def __init__(self) -> None:
        super().__init__()
        self.counts: Dict[str, int] = {}

    def record(self, name: str, seconds: float) -> None:
        super().record(name, seconds)
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        if not self.seconds:
            return "(no timed sections)"
        width = max(len(k) for k in self.seconds)
        return "\n".join(
            f"{k.ljust(width)}  {self.seconds[k]:10.3f}s  x{self.counts[k]}"
            for k in sorted(self.seconds, key=self.seconds.get, reverse=True))


class Timed(ContextDecorator):
    """`with Timed("read data"):` logs the elapsed wall clock on exit, adds
    it to `registry` and records a trace span of the section; with a CUDA
    `device` the clock stops, and the span closes, once the device has
    finished."""

    def __init__(self, message: str, *, registry: Optional[TimingRegistry] = None,
                 device: Optional[torch.device] = None):
        self.message = message
        self.registry = registry
        self.device = device
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "Timed":
        self._t0 = time.perf_counter()
        # span() is the shared no-op when tracing is off.
        self._span = telemetry.span(self.message)
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            if exc_type is None and self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self._span.__exit__(exc_type, exc, tb)
        self.elapsed = time.perf_counter() - self._t0
        status = "" if exc_type is None else f" (FAILED: {exc_type.__name__})"
        logger.info("%s: %.3fs%s", self.message, self.elapsed, status)
        if self.registry is not None:
            self.registry.record(self.message, self.elapsed)
        return False


def _resolve_level(level: str) -> int:
    """Unknown levels fall back to INFO with a warning: a typo in
    --logging-level must not abort a training job."""
    resolved = _LEVELS.get(level.upper())
    if resolved is None:
        logger.warning("unknown log level %r; falling back to INFO", level)
        return logging.INFO
    return resolved


class PhotonLogger:
    """Job-scoped file logger: attaches a file handler to the package
    logger; `close()` (or leaving the `with` block) detaches it, flushes,
    and restores the package logger's level."""

    def __init__(self, log_path: str, level: str = "INFO"):
        resolved = _resolve_level(level)
        self.log_path = log_path
        self.handler = logging.FileHandler(log_path)
        self.handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s - %(message)s"))
        self.handler.setLevel(resolved)
        self._prev_logger_level = logger.level
        logger.addHandler(self.handler)
        if logger.level == logging.NOTSET or logger.level > resolved:
            logger.setLevel(resolved)

    def close(self) -> None:
        logger.removeHandler(self.handler)
        self.handler.close()
        logger.setLevel(self._prev_logger_level)

    def __enter__(self) -> "PhotonLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


_STAGE_TLS = threading.local()


def _stage_stack() -> List[StageTimes]:
    stack = getattr(_STAGE_TLS, "stack", None)
    if stack is None:
        stack = _STAGE_TLS.stack = []
    return stack


@contextmanager
def stage_scope(registry: StageTimes):
    """Make `registry` this thread's ambient sink for `stage_timer`."""
    stack = _stage_stack()
    stack.append(registry)
    try:
        yield registry
    finally:
        stack.pop()


@contextmanager
def stage_timer(name: str):
    """`with stage_timer("serve_pack"):` records the block's wall clock into
    this thread's innermost `stage_scope` (nothing without one) and opens a
    trace span of the same name."""
    t0 = time.perf_counter()
    with telemetry.span(name):
        try:
            yield
        finally:
            stack = _stage_stack()
            if stack:
                stack[-1].record(name, time.perf_counter() - t0)


# ------------------------------------------------------------------ event bus


@dataclasses.dataclass(frozen=True)
class Event:
    """A lifecycle event (Event.scala:28)."""

    timestamp: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass(frozen=True)
class PhotonSetupEvent(Event):
    args: str = ""


@dataclasses.dataclass(frozen=True)
class TrainingStartEvent(Event):
    num_samples: int = 0


@dataclasses.dataclass(frozen=True)
class TrainingFinishEvent(Event):
    num_configs: int = 0
    best_metric: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PhotonFailureEvent(Event):
    error: str = ""


@dataclasses.dataclass(frozen=True)
class SweepConfigEvent(Event):
    """One configuration of the regularization sweep starting."""

    index: int = 0
    total: int = 0


@dataclasses.dataclass(frozen=True)
class CoordinateUpdateEvent(Event):
    """One coordinate-descent update finished, accepted or rejected by the
    divergence guard."""

    iteration: int = 0
    coordinate: str = ""
    seconds: float = 0.0
    accepted: bool = True


@dataclasses.dataclass(frozen=True)
class CheckpointEvent(Event):
    """One checkpoint step committed (its model files and state.json)."""

    step: int = 0
    coordinate: str = ""


class EventEmitter:
    """Synchronous listener bus (EventEmitter.scala:24-58): `send` calls
    every listener in registration order, and a listener that raises is
    logged, never allowed to break the job."""

    def __init__(self) -> None:
        self._listeners: List[Callable[[Event], None]] = []

    def register(self, listener: Callable[[Event], None]) -> None:
        self._listeners.append(listener)

    def send(self, event: Event) -> None:
        for listener in self._listeners:
            try:
                listener(event)
            except Exception:  # noqa: BLE001 - listener isolation
                logger.exception("event listener failed for %r", event)


def journal_listener(journal) -> Callable[[Event], None]:
    """An `EventEmitter` listener writing each lifecycle event as its typed
    line of a `telemetry.RunJournal` (contracts.JOURNAL_EVENT_SCHEMAS); an
    event type without a line is skipped."""

    def _listen(event: Event) -> None:
        if isinstance(event, PhotonSetupEvent):
            journal.emit("setup", args=event.args)
        elif isinstance(event, TrainingStartEvent):
            journal.emit("fit_start", num_samples=event.num_samples)
        elif isinstance(event, SweepConfigEvent):
            journal.emit("sweep_config", index=event.index, total=event.total)
        elif isinstance(event, CoordinateUpdateEvent):
            journal.emit("coordinate_update", iteration=event.iteration,
                         coordinate=event.coordinate, seconds=round(event.seconds, 6),
                         accepted=event.accepted)
        elif isinstance(event, CheckpointEvent):
            journal.emit("checkpoint", step=event.step, coordinate=event.coordinate)
        elif isinstance(event, TrainingFinishEvent):
            journal.emit("fit_finish", num_configs=event.num_configs,
                         best_metric=event.best_metric)
        elif isinstance(event, PhotonFailureEvent):
            journal.emit("failure", error=event.error)

    return _listen
