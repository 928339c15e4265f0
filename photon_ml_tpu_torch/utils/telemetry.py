"""Telemetry: spans, mergeable metrics, the run journal and the run profile.

Port of `photon_ml_tpu/utils/telemetry.py` for the layers the port has:

* **Spans.** `span(name)` opens a span under this thread's innermost open
  span; `span_handoff()` / `adopt_span()` carry the parent across a thread
  hand-off. With no tracer installed (`PHOTON_TRACE` off) `span()` returns
  one shared no-op context manager. `Tracer.export` writes Chrome
  trace-event JSON (Perfetto loads it).
* **Metrics.** Counters, gauges and histograms behind one registry
  (`METRICS`) over a closed name table (`METRIC_DESCRIPTIONS`: an
  undeclared name raises). Histograms share fixed log-spaced bucket bounds
  (16 a decade over 1e-4..1e7), so snapshots merge by adding counts
  (`merge_histogram_snapshots`) and a quantile lands within one bucket
  width of the exact one. Counters and histograms carry optional
  per-label sub-series (`metric_label_scope`, or `labels=`): a labelled
  observation lands in the aggregate histogram and in the label's own, over
  the same bounds, so the autopilot reads per-tenant p95s. `utils/faults.
  COUNTERS` is a view of this registry.
* **Run journal.** `RunJournal` writes one JSON line per event, each
  validated against `contracts.JOURNAL_EVENT_SCHEMAS` before it is written;
  `emit_event` writes into the installed journal (a no-op without one) and
  `validate_journal` checks a file afterwards.
* **Run profile.** `build_profile` / `write_profile` assemble and write a
  fit's or a serve run's `profile.json` with the reference's keys, and
  `read_profile` reads one back; both refuse a profile that lacks a key of
  its kind. `device_topology` reads `torch.cuda`.

Nothing here starts a thread or touches the card when imported.
"""

from __future__ import annotations

import bisect
import itertools
import json
import logging
import math
import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from photon_ml_tpu_torch.contracts import (
    JOURNAL_EVENT_SCHEMAS,
    JOURNAL_LINE_KEYS,
    PROFILE_FIT_KEYS,
    PROFILE_REQUIRED_KEYS,
    PROFILE_SERVE_KEYS,
)
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

# Every metric name the port records, each with the reference's one-line
# doc (a subset of the reference's table: the names its serving tier and
# coordinate descent use).
METRIC_DESCRIPTIONS = {
    "retries": "bounded-backoff retries of transient failures (faults.retry)",
    "fallback_sync_ckpt_writes": "staged checkpoint writes degraded to sync",
    "injected_faults": "faults fired by the deterministic injector",
    "quarantined_blocks": "corrupt Avro blocks quarantined on read",
    "serving_degraded_batches": "batches degraded to per-request dispatch",
    "serving_shed_requests": "submits shed by admission control",
    "serving_deadline_misses": "requests failed past their deadline budget",
    "serving_circuit_opens": "circuit-breaker CLOSED->OPEN transitions",
    "serving_fe_only_requests": "requests answered by the FE-only tier",
    "serving_swaps": "bundle hot-swaps committed",
    "serving_swap_rollbacks": "bundle hot-swaps rolled back",
    "serving_flush_thread_failures": "micro-batcher flush-thread deaths",
    "collective_retries": "mesh collective program re-dispatches",
    "shard_upload_retries": "per-shard serving staging retries",
    "watchdog_trips": "device dispatches past the watchdog deadline",
    "shard_loss_fallbacks": "requests answered pinned-zero for a lost shard",
    "serving_latency_ms": "per-request wall latency through the batcher",
    "serving_queue_wait_ms": "submit-to-claim queue wait per request",
    "serving_batch_size": "requests per dispatched micro-batch",
    "serving_pending_depth": "batcher queue depth observed at batch claim",
    "serving_bundle_generation": "live bundle generation after a hot-swap",
    "coordinate_update_s": "wall seconds per coordinate-descent update",
    "mesh_losses": "mesh-loss faults recovered at a sweep boundary",
    "delta_applies": "delta-bundle generation flips committed to a live "
    "engine",
    "delta_rollbacks": "delta-bundle applies rolled back to the old "
    "generation",
    "delta_rows_staged": "changed/added RE rows staged by delta applies",
    "host_losses": "whole-host losses detected in the multi-host process "
    "group (heartbeat or wedged collective)",
    "host_heartbeat_misses": "per-host heartbeat beats missed by a peer "
    "before it was declared lost",
    "promote_failures": "failed two-tier hot-set promotions",
    "tenant_demotions": "cold tenants' RE rows demoted to the host tier "
    "under HBM pressure",
    "tenant_restores": "demoted tenants promoted back to full HBM "
    "residency when headroom returned",
    "tenant_cobatch_dispatches": "cross-tenant co-batched device dispatches",
    "shadow_mirrored_requests": "champion requests mirrored to a shadow "
    "challenger tenant",
    "shadow_mirror_failures": "mirror submits degraded to champion-only "
    "serving (never a failed client request)",
    "label_join_failures": "online-evaluation label joins dropped (label "
    "lost, champion path untouched)",
    "shadow_windows": "shadow evaluation windows scored through the "
    "jitted metric programs",
    "shadow_promotions": "challengers promoted to champion via the "
    "BundleManager generation flip",
    "shadow_rollbacks": "challengers torn down on a regression verdict "
    "or a failed promotion",
    "shadow_score_drift": "per-request |champion - challenger| mean-score "
    "drift observed at window evaluation",
    "shadow_calibration_champion": "per-request |champion mean - label| "
    "calibration error per evaluated window",
    "shadow_calibration_challenger": "per-request |challenger mean - label| "
    "calibration error per evaluated window",
    "reshard_retries": "per-shard staging retries during a live reshard",
    "reshard_rollbacks": "live mesh reshards rolled back to the old generation",
    "rebalanced_rows": "hot coefficient rows re-placed by a rebalance plan",
    "autopilot_actions": "control-rule actuations applied by the "
    "autopilot loop (reshard, rebalance, demote/restore, retune)",
    "autopilot_suppressed": "control-rule firings suppressed by "
    "hysteresis, cooldown, quarantine, or the action budget",
    "autopilot_rollbacks": "autopilot actions reverted because the "
    "post-action contract probe regressed",
    "autopilot_quarantines": "control rules benched after a rollback "
    "until an operator reset",
    "tier_demotions": "precision-ladder steps down (f32->bf16->int8->"
    "host) committed on a serving tenant",
    "tier_restores": "precision-ladder steps back up toward f32 "
    "committed on a serving tenant",
    "tier_rollbacks": "ladder transitions abandoned after retry "
    "exhaustion, the old generation still serving",
    "tier_quant_error": "per-coordinate worst relative round-trip error "
    "measured at each quantization (labeled per tenant) — the "
    "characterized-parity evidence behind contracts.TIER_TOLERANCES",
}

_BUCKETS_PER_DECADE = 16
_MIN_DECADE, _MAX_DECADE = -4, 7
BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    10.0 ** (k / _BUCKETS_PER_DECADE)
    for k in range(_MIN_DECADE * _BUCKETS_PER_DECADE, _MAX_DECADE * _BUCKETS_PER_DECADE + 1)
)


class Histogram:
    """Thread-safe histogram over the shared fixed bounds, with exact
    count/sum/min/max. Values at or below the first bound land in bucket 0,
    values past the last in the overflow bucket."""

    def __init__(self) -> None:
        self._counts: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def record(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(BUCKET_BOUNDS, value)
        with self._lock:
            self._counts[idx] = self._counts.get(idx, 0) + 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def snapshot(self) -> Dict[str, object]:
        """JSON-serializable state (sparse bucket counts keyed by index)."""
        with self._lock:
            return {"buckets": {str(k): v for k, v in sorted(self._counts.items())},
                    "count": self.count, "sum": self.sum, "min": self.min, "max": self.max}

    def quantile(self, q: float) -> Optional[float]:
        return snapshot_quantile(self.snapshot(), q)


def _bucket_value(idx: int) -> float:
    """Bucket `idx`'s geometric midpoint (its bound at the edges)."""
    if idx <= 0:
        return BUCKET_BOUNDS[0]
    if idx >= len(BUCKET_BOUNDS):
        return BUCKET_BOUNDS[-1]
    return math.sqrt(BUCKET_BOUNDS[idx - 1] * BUCKET_BOUNDS[idx])


def snapshot_quantile(snap: Mapping[str, object], q: float) -> Optional[float]:
    """Quantile from a histogram snapshot (merged or not), clamped to the
    recorded min and max: within one bucket width of the exact value."""
    count = int(snap.get("count") or 0)
    if count == 0:
        return None
    target = q * count
    seen = 0
    for idx, n in sorted((int(k), int(v)) for k, v in dict(snap["buckets"]).items()):
        seen += n
        if seen >= target:
            value = _bucket_value(idx)
            lo, hi = snap.get("min"), snap.get("max")
            if lo is not None:
                value = max(value, float(lo))
            if hi is not None:
                value = min(value, float(hi))
            return value
    return snap.get("max")


def merge_histogram_snapshots(*snaps: Mapping[str, object]) -> Dict[str, object]:
    """Associative, order-independent merge of histogram snapshots."""
    buckets: Dict[str, int] = {}
    count = 0
    total = 0.0
    lo: Optional[float] = None
    hi: Optional[float] = None
    for s in snaps:
        for k, v in dict(s.get("buckets") or {}).items():
            key = str(int(k))
            buckets[key] = buckets.get(key, 0) + int(v)
        count += int(s.get("count") or 0)
        total += float(s.get("sum") or 0.0)
        if s.get("min") is not None:
            lo = float(s["min"]) if lo is None else min(lo, float(s["min"]))
        if s.get("max") is not None:
            hi = float(s["max"]) if hi is None else max(hi, float(s["max"]))
    return {"buckets": {k: buckets[k] for k in sorted(buckets, key=int)},
            "count": count, "sum": total, "min": lo, "max": hi}


# ------------------------------------------------------------- metric labels

_LABEL_TLS = threading.local()


def current_metric_labels() -> Optional[Tuple[Tuple[str, str], ...]]:
    """This thread's ambient metric labels, or None outside a scope."""
    return getattr(_LABEL_TLS, "labels", None)


class metric_label_scope:
    """Attach labels to every counter increment on this thread for the
    scope's duration; an inner scope replaces an outer one."""

    __slots__ = ("_labels", "_prev")

    def __init__(self, **labels: str):
        self._labels = tuple(sorted((k, str(v)) for k, v in labels.items()))
        self._prev = None

    def __enter__(self) -> "metric_label_scope":
        self._prev = getattr(_LABEL_TLS, "labels", None)
        _LABEL_TLS.labels = self._labels
        return self

    def __exit__(self, *exc) -> bool:
        _LABEL_TLS.labels = self._prev
        return False


def label_key(labels: Tuple[Tuple[str, str], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in labels)


class MetricsRegistry:
    """Counters, gauges and histograms over the closed name table; a
    labelled increment also counts into the label's sub-count, a labelled
    observation into the label's sub-histogram."""

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}
        self._labeled: Dict[str, Dict[str, int]] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}
        self._labeled_hists: Dict[str, Dict[str, Histogram]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _check(name: str) -> None:
        if name not in METRIC_DESCRIPTIONS:
            raise KeyError(f"undeclared metric {name!r}: add it to "
                           "photon_ml_tpu_torch.utils.telemetry.METRIC_DESCRIPTIONS")

    def increment(self, name: str, by: int = 1,
                  labels: Optional[Tuple[Tuple[str, str], ...]] = None) -> None:
        self._check(name)
        if labels is None:
            labels = current_metric_labels()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by
            if labels:
                sub = self._labeled.setdefault(name, {})
                key = label_key(labels)
                sub[key] = sub.get(key, 0) + by

    def get_counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def labeled_counters(self, name: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._labeled.get(name, {}))

    def set_gauge(self, name: str, value: float) -> None:
        self._check(name)
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Tuple[Tuple[str, str], ...]] = None) -> None:
        self._check(name)
        if labels is None:
            labels = current_metric_labels()
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram()
            labeled = None
            if labels:
                sub = self._labeled_hists.setdefault(name, {})
                key = label_key(labels)
                labeled = sub.get(key)
                if labeled is None:
                    labeled = sub[key] = Histogram()
        hist.record(value)
        if labeled is not None:
            labeled.record(value)

    def histogram(self, name: str) -> Optional[Histogram]:
        with self._lock:
            return self._hists.get(name)

    def labeled_histogram(self, name: str,
                          labels: Tuple[Tuple[str, str], ...]) -> Optional[Histogram]:
        """One label's live sub-histogram, or None if never observed."""
        with self._lock:
            return self._labeled_hists.get(name, {}).get(label_key(labels))

    def labeled_histograms(self, name: str) -> Dict[str, Dict[str, object]]:
        """Per-label snapshots of one histogram ({"tenant=a": {...}}); empty
        when nothing labelled observed it."""
        with self._lock:
            sub = dict(self._labeled_hists.get(name, {}))
        return {k: h.snapshot() for k, h in sorted(sub.items())}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            hists = dict(self._hists)
            labeled_hists = {k: dict(v) for k, v in sorted(self._labeled_hists.items())}
            out = {"counters": dict(self._counters),
                   "labeled_counters": {k: dict(v) for k, v in sorted(self._labeled.items())},
                   "gauges": dict(self._gauges)}
        out["histograms"] = {k: h.snapshot() for k, h in sorted(hists.items())}
        out["labeled_histograms"] = {k: {lk: h.snapshot() for lk, h in sorted(v.items())}
                                     for k, v in labeled_hists.items()}
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._labeled.clear()
            self._gauges.clear()
            self._hists.clear()
            self._labeled_hists.clear()


METRICS = MetricsRegistry()


class LatencyStats:
    """A mergeable histogram plus the first `reservoir` samples: exact
    percentiles while every sample fits the reservoir, the histogram's
    (within one bucket width) beyond it. Memory stays bounded."""

    def __init__(self, reservoir: int = 4096):
        self._reservoir_cap = int(reservoir)
        self._reservoir: List[float] = []
        self._hist = Histogram()
        self._lock = threading.Lock()

    def record(self, value_ms: float) -> None:
        self._hist.record(value_ms)
        with self._lock:
            if len(self._reservoir) < self._reservoir_cap:
                self._reservoir.append(float(value_ms))

    @property
    def count(self) -> int:
        return self._hist.count

    def percentile(self, q_pct: float) -> Optional[float]:
        with self._lock:
            exact = list(self._reservoir) if self._hist.count <= len(self._reservoir) else None
        if exact is not None:
            if not exact:
                return None
            exact.sort()
            pos = (len(exact) - 1) * q_pct / 100.0  # linear interpolation, numpy's default
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(exact) - 1)
            return exact[lo] + (exact[hi] - exact[lo]) * (pos - lo)
        return self._hist.quantile(q_pct / 100.0)

# ------------------------------------------------------------------- tracing


def trace_from_env() -> bool:
    """The PHOTON_TRACE knob: the drivers start a tracer when it is on."""
    return bool(get_knob("PHOTON_TRACE"))


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span: records a Chrome 'X' (complete) event on exit."""

    __slots__ = ("tracer", "name", "args", "span_id", "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, object]):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.span_id = next(tracer._ids)
        self.parent_id: Optional[int] = None
        self._t0 = 0

    def set(self, **args) -> None:
        self.args.update(args)

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        if stack:
            self.parent_id = stack[-1]
        else:
            self.parent_id = getattr(self.tracer._tls, "adopted_parent", None)
        stack.append(self.span_id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter_ns()
        stack = self.tracer._stack()
        if stack and stack[-1] == self.span_id:
            stack.pop()
        if exc_type is not None:
            self.args["error"] = exc_type.__name__
        self.tracer._record(self, self._t0, t1)
        return False


class Tracer:
    """Thread-aware span collector exporting Chrome trace-event JSON."""

    def __init__(self) -> None:
        self.trace_id = f"{os.getpid():x}-{time.time_ns():x}"
        self._events: List[dict] = []
        self._threads: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)
        # Track ids for a thread that reuses a finished thread's ident under
        # another name, far past real idents.
        self._synth_tids = itertools.count(1 << 48)
        self._t0_ns = time.perf_counter_ns()
        self._wall_t0 = time.time()

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _tid(self, thread: threading.Thread) -> int:
        tid = getattr(self._tls, "tid", None)
        if tid is None:
            with self._lock:
                tid = thread.ident
                if self._threads.get(tid, thread.name) != thread.name:
                    tid = next(self._synth_tids)
                self._threads[tid] = thread.name
            self._tls.tid = tid
        return tid

    def _record(self, span: _Span, t0_ns: int, t1_ns: int) -> None:
        args = dict(span.args)
        args["span_id"] = span.span_id
        if span.parent_id is not None:
            args["parent_id"] = span.parent_id
        event = {"name": span.name, "ph": "X", "ts": (t0_ns - self._t0_ns) / 1e3,
                 "dur": max(0.0, (t1_ns - t0_ns) / 1e3), "pid": os.getpid(),
                 "tid": self._tid(threading.current_thread()), "args": args}
        with self._lock:
            self._events.append(event)

    def spans(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self) -> Dict[str, object]:
        with self._lock:
            events = list(self._events)
            threads = dict(self._threads)
        meta = [{"name": "thread_name", "ph": "M", "pid": os.getpid(), "tid": tid,
                 "args": {"name": tname}} for tid, tname in sorted(threads.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"trace_id": self.trace_id, "wall_t0_unix_s": self._wall_t0}}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON atomically; returns `path`."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


_TRACER: Optional[Tracer] = None


def install_tracer(tracer: Tracer) -> Tracer:
    global _TRACER
    _TRACER = tracer
    return tracer


def uninstall_tracer() -> Optional[Tracer]:
    global _TRACER
    tracer, _TRACER = _TRACER, None
    return tracer


def current_tracer() -> Optional[Tracer]:
    return _TRACER


def start_tracing_if_enabled() -> Optional[Tracer]:
    """Install a fresh tracer when PHOTON_TRACE is on (and none is)."""
    if trace_from_env() and _TRACER is None:
        return install_tracer(Tracer())
    return _TRACER


def span(name: str, **args):
    """Open a span under this thread's innermost open span; the shared
    no-op context manager when no tracer is installed."""
    tracer = _TRACER
    if tracer is None:
        return _NULL_SPAN
    return _Span(tracer, name, args)


def span_handoff() -> Optional[Tuple[Tracer, Optional[int]]]:
    """(tracer, current span id), captured where work is handed to a thread."""
    tracer = _TRACER
    if tracer is None:
        return None
    stack = tracer._stack()
    return (tracer, stack[-1] if stack else getattr(tracer._tls, "adopted_parent", None))


class _Adopt:
    __slots__ = ("handoff", "_prev")

    def __init__(self, handoff):
        self.handoff = handoff
        self._prev = None

    def __enter__(self):
        if self.handoff is not None:
            tracer, parent = self.handoff
            self._prev = getattr(tracer._tls, "adopted_parent", None)
            tracer._tls.adopted_parent = parent
        return self

    def __exit__(self, *exc):
        if self.handoff is not None:
            self.handoff[0]._tls.adopted_parent = self._prev
        return False


def adopt_span(handoff: Optional[Tuple[Tracer, Optional[int]]]):
    """The worker side of `span_handoff`: spans opened inside parent under
    the span that handed the work over (a no-op for None)."""
    return _Adopt(handoff)


# ------------------------------------------------------------------- journal


def _check_event(etype: str, fields: Mapping[str, object]) -> Optional[str]:
    schema = JOURNAL_EVENT_SCHEMAS.get(etype)
    if schema is None:
        return f"unknown event type {etype!r}"
    missing = [k for k in schema if k not in fields]
    extra = [k for k in fields if k not in schema]
    if missing or extra:
        return f"{etype} schema mismatch (missing {missing}, unexpected {extra})"
    return None


class RunJournal:
    """JSON-lines sink of typed run events. A new journal truncates its
    file (one run's journal); every line is checked against its schema
    before it is written, so the file never holds a line its schema
    rejects."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "w")
        self._lock = threading.Lock()
        self._closed = False

    def emit(self, etype: str, **fields) -> None:
        error = _check_event(etype, fields)
        if error is not None:
            raise ValueError(f"journal event refused: {error}")
        text = json.dumps({"ts": round(time.time(), 6), "type": etype, **fields}, default=str)
        with self._lock:
            if self._closed:
                return
            self._f.write(text + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._f.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


_JOURNAL: Optional[RunJournal] = None


def install_journal(journal: RunJournal) -> RunJournal:
    global _JOURNAL
    _JOURNAL = journal
    return journal


def uninstall_journal() -> Optional[RunJournal]:
    global _JOURNAL
    journal, _JOURNAL = _JOURNAL, None
    return journal


def current_journal() -> Optional[RunJournal]:
    return _JOURNAL


def emit_event(etype: str, **fields) -> None:
    """Write into the installed journal (a no-op without one); a line that
    does not match its schema raises."""
    journal = _JOURNAL
    if journal is not None:
        journal.emit(etype, **fields)


def validate_journal(path: str) -> Tuple[int, List[str]]:
    """Check a journal file line by line: (valid lines, errors)."""
    n_ok = 0
    errors: List[str] = []
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            raw = raw.strip()
            if not raw:
                continue
            try:
                doc = json.loads(raw)
            except ValueError as exc:
                errors.append(f"line {lineno}: not JSON ({exc})")
                continue
            error = _check_event(doc.get("type"),
                                 {k: v for k, v in doc.items() if k not in JOURNAL_LINE_KEYS})
            if error is not None and doc.get("type") not in JOURNAL_EVENT_SCHEMAS:
                errors.append(f"line {lineno}: {error}")
            elif "ts" not in doc:
                errors.append(f"line {lineno}: missing ts")
            elif error is not None:
                errors.append(f"line {lineno}: {error}")
            else:
                n_ok += 1
    return n_ok, errors


# ------------------------------------------------------------------- profile

# Published memory rate of a card model (GB/s), by `torch.cuda.get_device_name`.
HBM_ROOFLINE_GB_S = {"NVIDIA H100 80GB HBM3": 3350.0}


def device_topology(device=None) -> Dict[str, object]:
    """The devices a profile was measured on: the card's name and count on
    a CUDA device, the host alone on the CPU."""
    import torch

    if device is not None and torch.device(device).type == "cuda":
        return {"platform": "gpu", "device_count": torch.cuda.device_count(),
                "device_kind": torch.cuda.get_device_name(torch.device(device)),
                "process_count": 1, "host_cpus": os.cpu_count()}
    return {"platform": "cpu", "device_count": 1, "device_kind": "cpu", "process_count": 1,
            "host_cpus": os.cpu_count()}


def build_profile(kind: str, *, wall_s: float, stages: Mapping[str, float],
                  dispatch: Mapping[str, object], bucket_shapes: Mapping[str, object],
                  fit_timing: Optional[Mapping[str, object]] = None,
                  ingest: Optional[Mapping[str, object]] = None,
                  serving: Optional[Mapping[str, object]] = None,
                  metrics: Optional[Mapping[str, object]] = None,
                  topology: Optional[Mapping[str, object]] = None) -> Dict[str, object]:
    """A run profile of `kind` "fit" or "serve"; the kind's own sections
    are required (a fit's `fit_timing`, a serve run's `serving`). The
    roofline is the card's own memory rate, None off a known card."""
    if kind not in ("fit", "serve"):
        raise ValueError(f"profile kind must be 'fit' or 'serve', not {kind!r}")
    topo = dict(topology if topology is not None else device_topology())
    profile: Dict[str, object] = {
        "kind": kind, "wall_s": round(float(wall_s), 4), "stages": dict(stages),
        "dispatch": dict(dispatch), "bucket_shapes": dict(bucket_shapes),
        "device_topology": topo,
        "roofline": {"hbm_gb_per_s": HBM_ROOFLINE_GB_S.get(topo.get("device_kind"))},
        "metrics": dict(metrics if metrics is not None else METRICS.snapshot())}
    if kind == "fit":
        if fit_timing is None:
            raise ValueError("fit profiles need fit_timing")
        profile["fit_timing"] = dict(fit_timing)
        profile["ingest"] = dict(ingest or {})
    else:
        if serving is None:
            raise ValueError("serve profiles need the serving metrics block")
        profile["serving"] = dict(serving)
    return profile


def _profile_schema(kind: str) -> Sequence[str]:
    if kind == "fit":
        return PROFILE_FIT_KEYS
    if kind == "serve":
        return PROFILE_SERVE_KEYS
    return PROFILE_REQUIRED_KEYS


def write_profile(path: str, profile: Mapping[str, object]) -> str:
    """Check the profile's keys against its kind's contract, then write it
    atomically."""
    missing = [k for k in _profile_schema(str(profile.get("kind"))) if k not in profile]
    if missing:
        raise ValueError(f"refusing to write a profile missing contract keys {missing}")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(profile, f, indent=2, default=str)
    os.replace(tmp, path)
    return path


def read_profile(path: str, kind: Optional[str] = None) -> Dict[str, object]:
    """A profile read back: one of another kind than `kind`, or one that
    lacks a key of its kind, raises."""
    with open(path) as f:
        profile = json.load(f)
    found_kind = profile.get("kind")
    if kind is not None and found_kind != kind:
        raise ValueError(f"profile at {path} has kind {found_kind!r}, expected {kind!r}")
    missing = [k for k in _profile_schema(str(found_kind)) if k not in profile]
    if missing:
        raise ValueError(f"profile at {path} is missing contract keys {missing} "
                         f"(got {sorted(profile)}) — the run-profile contract is broken")
    return profile
