"""Per-call stage timing: the part of the JAX package's
`utils/observability.py` that ingest and the estimator use.

A `StageTimes` is made by the caller for one operation (one
`read_game_dataset` call, one estimator's prepare stages) and passed down
explicitly: `stage(name)` times a
block into it (and records it as a trace span of the same name),
`record` adds seconds measured elsewhere (a decode worker
thread records its own wall), and `note` keeps a string annotation (which
route ran). It is thread-safe, so worker threads of one call record into
it directly; nothing here is process-wide.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch

from photon_ml_tpu_torch.utils import telemetry


class StageTimes:
    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.notes: Dict[str, str] = {}
        self._lock = threading.Lock()

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    @contextmanager
    def stage(self, name: str, device: Optional[torch.device] = None) -> Iterator[None]:
        """`with times.stage("ell"):` adds the block's wall clock to `name`
        and opens a span of that name. With a CUDA `device`, the clock stops
        and the span closes once the device has finished the block's work."""
        t0 = time.perf_counter()
        with telemetry.span(name):
            try:
                yield
            finally:
                if device is not None and device.type == "cuda":
                    torch.cuda.synchronize(device)
                self.record(name, time.perf_counter() - t0)

    def note(self, name: str, value: str) -> None:
        with self._lock:
            self.notes[name] = value

    def get(self, name: str) -> float:
        with self._lock:
            return self.seconds.get(name, 0.0)

    def get_note(self, name: str) -> Optional[str]:
        with self._lock:
            return self.notes.get(name)
