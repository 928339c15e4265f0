"""Multi-tenant serving: several named model bundles on one card.

Port of `photon_ml_tpu/serving/tenancy.py`. `TenantRegistry` keeps N
tenants in one process and enforces what one process per model gives for
free:

* **Per-tenant admission quotas and deadlines.** Each tenant holds at most
  `PHOTON_TENANT_MAX_PENDING` requests in flight (or its `max_pending`); a
  submit past it sheds with a typed `Overloaded` naming the tenant. A
  request's deadline defaults per tenant and is enforced when it is
  claimed, before it takes a device slot.
* **Weighted-fair co-batching.** One dispatch thread
  (`photon-tenant-dispatch`) claims up to `max_batch` requests a round,
  splitting the slots over the backlogged tenants by weight (each gets at
  least one), and runs the requests of tenants that share a co-batch
  signature as ONE device dispatch: every slot gathers its own tenant's
  parameters (the fixed effects' stacked weight rows, and each random
  effect's matrix gathered at each member's rows, selected by tenant id
  with `torch.where`), through the engine's own margin functions
  (`dense_margins`, `gathered_row_margins`), so a co-batched answer is its
  solo answer bit for bit. A tenant outside every signature (normalized,
  two-tier, row-sharded over cards, a lost shard) dispatches solo through
  its own micro-batcher.
* **Co-batch programs on the card are CUDA graphs.** A graph reads fixed
  addresses, so it is captured for one generation of each member: its key
  is (signature, each member's name and state generation, bucket). A
  generation is unique in the process, where a version is not: a
  rolled-back flip's version comes again, and every engine starts at 0.
  The captures run in the pre-warm of an admission, of every member's
  generation change (swap, delta, demote, restore, shadow promote: the
  engine's `_prewarm_hook`, called by `BundleManager._stage_and_commit`
  before the commit) and of a removal; a failed capture fails that
  admission or change through its rollback. The programs of a generation
  that will never serve again (retired after its drain, rolled back, or a
  failed admission's) are dropped at once; those of a group whose
  membership changed go between dispatch rounds. `cobatch_compiles` counts the
  captures, `cobatch_compiles_after_warmup` those the dispatch path had to
  make itself (0 on a clean run).
* **Per-tenant failure domains.** Every tenant owns a `ServingEngine`
  (health, circuit breaker, watchdog, fault gate `inject_faults`) and a
  micro-batcher (`photon-tenant-<name>-flush`, its counters labelled with
  the tenant); the engines share one device mutex. A co-batch fault
  degrades only the tenant that owns it to its solo path; a whole-dispatch
  failure degrades every slice to its own tenant's batcher.
* **Device-memory pressure.** Admission charges every tenant's device bytes
  (`_bundle_device_bytes`, the peak on one card: a two-tier store's hot
  plane, not its host matrix; a row-sharded matrix per card) against `PHOTON_TENANT_HBM_FRACTION` of the card's budget. While
  a newcomer does not fit, the coldest (least recently active) tenant's
  random effects are demoted to the host tier
  (`bundle.demote_bundle_to_host_tier`): it keeps answering bit-equal, it
  only stops pinning its matrices. Admission refuses
  (`HbmBudgetExceeded`) only when nothing fits after every demotion. The
  valve keeps no hot rows; `demote(name, hot_rows=n)` keeps n rows of each
  random effect on the card.
* **The precision ladder.** `demote_tier` walks a tenant's random-effect
  rows down f32 -> bf16 -> int8 -> host, one rung a call (or to the rung
  `to=`), and `restore_tier` walks them back up; each quantized step is a
  generation change through `BundleManager._stage_and_commit` (quantize,
  pre-warm the new kind's programs, commit, drain), and the step to f32 is
  bit-equal (built from the retained original rows). A quantized tenant
  answers as float32 scoring over its dequantized rows (the error against
  its f32 answers is what `contracts.TIER_TOLERANCES[rung]` characterizes),
  and dispatches solo (no co-batch signature). An int8 step whose round-trip
  error passes PHOTON_TIER_INT8_ERROR_CEILING raises
  `TierErrorCeilingExceeded` before the commit. With PHOTON_TIER_LADDER on,
  the pressure valve steps the coldest quantizable tenant one rung down
  before it demotes any tenant to the host tier.

Fault sites: `tenant_admit` (staging a tenant, bounded retry; a failure
leaves the registry without it), `tenant_evict` (the demotion build,
bounded retry; a failure rolls back and the tenant keeps serving its
device-resident generation), `quantize_stage` and `tier_restore` (a ladder
step's build, bounded retry; a failure rolls back, counted in
`tier_rollbacks`, with the old generation serving). Journal events:
`tenant_admit`, `tenant_evict`, `tenant_restore`, `tenant_degraded`,
`tier_demote` and `tier_restore`.

`max_batch` and `max_wait_ms` default to the planner's
`serving_max_batch` and `serving_max_wait_ms`; `retune(max_wait_ms=)`
moves the wait live (the autopilot's retune actuator), never the bucket
ladder.
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

from photon_ml_tpu_torch.contracts import TENANT_BLOCK_KEYS, TIER_BLOCK_KEYS
from photon_ml_tpu_torch.game.model import gathered_row_margins
from photon_ml_tpu_torch.ops.losses import mean_for_task
from photon_ml_tpu_torch.serving.bundle import (
    PRECISION_LADDER,
    ScoreRequest,
    ServingBundle,
    demote_bundle_to_host_tier,
    promote_bundle_from_host_tier,
    quantize_bundle_rows,
    restore_bundle_precision,
)
from photon_ml_tpu_torch.serving.engine import (
    ScoreResult,
    ServingEngine,
    _bucket_sizes,
    capture_graph,
)
from photon_ml_tpu_torch.serving.lifecycle import (
    BatcherUnhealthy,
    DeadlineExceeded,
    HbmBudgetExceeded,
    Overloaded,
    _bundle_device_bytes,
    device_memory_budget_bytes,
)
from photon_ml_tpu_torch.transformers.game_transformer import dense_margins
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob
from photon_ml_tpu_torch.utils.watchdog import Watchdog, watchdog_ms

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

# One queued request: (request, future, submit time, absolute expiry or None).
_Pending = Tuple[ScoreRequest, Future, float, Optional[float]]


class TierErrorCeilingExceeded(RuntimeError):
    """An int8 quantization's measured round-trip error passed
    PHOTON_TIER_INT8_ERROR_CEILING: the build is dropped before the commit
    and the tenant stays on its rung (a ladder walker falls through to the
    bit-equal host tier instead)."""


def _cobatch_program(offsets: Tensor, tids: Tensor, feats: Sequence[Tensor], rows: tuple,
                     params: tuple, *, kinds: Tuple[str, ...], task) -> Tuple[Tensor, Tensor]:
    """One dispatch over a bucket whose slots belong to different tenants.

    Per coordinate position k (every member shares the (kind, dim)
    structure, with no normalization):

    * "fe": `params[k]` is the members' weight vectors stacked (T, dim), and
      each slot gathers its tenant's row; `dense_margins` on (B, dim) rows
      does the solo engine's multiply and row reduction per element.
    * "re": each member's matrix is gathered at its own row vector (a slot
      of another tenant points at that member's pinned zero row, so every
      gather is in bounds), and `torch.where` on the tenant id selects each
      slot's row: a select, so no foreign value enters the arithmetic.

    Padding slots carry tenant 0 and pinned zero rows; their outputs are
    dropped."""
    total = offsets
    for k, kind in enumerate(kinds):
        f = feats[k]
        if kind == "fe":
            total = total + dense_margins(f, params[k][tids], None)
        else:
            mats, member_rows = params[k], rows[k]
            w = mats[0][member_rows[0]]
            for t in range(1, len(mats)):
                w = torch.where((tids == t)[:, None], mats[t][member_rows[t]], w)
            total = total + gathered_row_margins(f, w, None)
    return total, mean_for_task(task, total)


class _CobatchProgram:
    """One co-batch program: static device inputs for one signature, one
    generation of each member and one bucket; on the card the captured graph.
    Built and run under the registry's device mutex."""

    def __init__(self, sig: tuple, states: Sequence, bucket: int, device: torch.device):
        task, kinds, dims = sig
        cuda = device.type == "cuda"
        f32, i64 = torch.float32, torch.int64
        self.offsets = torch.zeros(bucket, dtype=f32, device=device)
        self.tids = torch.zeros(bucket, dtype=i64, device=device)
        self.feats = [torch.zeros((bucket, d), dtype=f32, device=device) for d in dims]
        self.rows = {k: [torch.full((bucket,), st.coords[k].unseen_row, dtype=i64, device=device)
                         for st in states]
                     for k, kind in enumerate(kinds) if kind == "re"}
        self.host_offsets = torch.zeros(bucket, dtype=f32, pin_memory=cuda)
        self.host_tids = torch.zeros(bucket, dtype=i64, pin_memory=cuda)
        self.host_feats = [torch.zeros((bucket, d), dtype=f32, pin_memory=cuda) for d in dims]
        self.host_rows = {k: [torch.zeros(bucket, dtype=i64, pin_memory=cuda) for _ in states]
                          for k in self.rows}
        self.host_out = torch.zeros((2, bucket), dtype=f32, pin_memory=cuda)
        params = tuple(
            torch.stack([st.coords[k].params for st in states]) if kind == "fe"
            else tuple(st.coords[k].params for st in states)
            for k, kind in enumerate(kinds))
        rows = tuple(self.rows.get(k) for k in range(len(kinds)))

        def program() -> Tensor:
            total, means = _cobatch_program(self.offsets, self.tids, self.feats, rows, params,
                                            kinds=kinds, task=task)
            return torch.stack((total, means))

        self._program = program
        self.graph, self.out = capture_graph(program, device) if cuda else (None, None)

    def run(self, offsets, tids, feats, rows, stream) -> Tuple[np.ndarray, np.ndarray]:
        self.host_offsets.numpy()[:] = offsets
        self.host_tids.numpy()[:] = tids
        for buf, f in zip(self.host_feats, feats):
            buf.numpy()[:] = f
        for k, bufs in self.host_rows.items():
            for buf, r in zip(bufs, rows[k]):
                buf.numpy()[:] = r
        pairs = [(self.offsets, self.host_offsets), (self.tids, self.host_tids)]
        pairs += list(zip(self.feats, self.host_feats))
        pairs += [(d, h) for k in self.rows for d, h in zip(self.rows[k], self.host_rows[k])]
        if self.graph is None:
            for dst, src in pairs:
                dst.copy_(src)
            self.host_out.copy_(self._program())
        else:
            with torch.cuda.stream(stream):
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
                self.graph.replay()
                self.host_out.copy_(self.out, non_blocking=True)
            stream.synchronize()
        out = self.host_out.numpy().copy()
        return out[0], out[1]


def _signature(task, state) -> Optional[tuple]:
    """The co-batch key of one engine state, or None when it must dispatch
    solo: every coordinate "fe" or "re" (single-tier on the card: a
    coordinate row-sharded over cards, "re_sh", gathers differently), no
    normalization, no lost shard."""
    for k, c in enumerate(state.coords):
        if state.kinds[k] not in ("fe", "re") or c.norm is not None:
            return None
        if c.shard_health is not None and c.shard_health.any_lost:
            return None
    return (task, state.kinds, tuple(c.dim for c in state.coords))


class Tenant:
    """One tenant's serving stack: its own engine (health, breaker,
    watchdog, fault gate), its micro-batcher (the solo and fallback path),
    its quota, deadline and weight, and its queue on the registry's
    co-batched path."""

    def __init__(self, name: str, engine: ServingEngine, batcher, *, quota: int,
                 deadline_ms: Optional[float], weight: float, order: int):
        self.name = name
        self.engine = engine
        self.batcher = batcher
        self.quota = int(quota)
        self.deadline_ms = deadline_ms
        self.weight = float(weight)
        self.order = int(order)  # admission order: the member index in a group
        self.queue: Deque[_Pending] = collections.deque()
        self.in_flight = 0  # both paths: submitted, not yet resolved
        self.demoted = False
        self.draining = False  # remove() in progress: new submits refused
        self.last_active = time.monotonic()
        self.completed = 0
        self.failed = 0
        self.shed = 0
        self.deadline_missed = 0
        self.cobatched = 0
        self.cobatch_degraded = 0
        self.latency = telemetry.LatencyStats()
        self._seen_reasons: Tuple[str, ...] = ()
        # The precision ladder: the rung ("f32", "bf16", "int8"; a tenant
        # demoted to the host tier keeps its last rung beside demoted=True),
        # its transitions, and the worst round-trip error measured (None
        # until the first quantization): the metrics' `tier` block.
        self.tier = "f32"
        self.tier_demotions = 0
        self.tier_restores = 0
        self.tier_rollbacks = 0
        self.quant_error_max: Optional[float] = None

    @property
    def bundle(self) -> ServingBundle:
        return self.engine.bundle

    def device_bytes(self) -> int:
        return _bundle_device_bytes(self.engine._state.bundle)

    def can_demote(self) -> bool:
        """Whether the pressure valve may pick this tenant: not demoted yet,
        and no coordinate staged in row blocks or row-sharded over cards (a
        placement, which the host tier would not keep)."""
        if self.demoted:
            return False
        return all(c.row_blocks is None and c.mesh is None for c in self.engine._state.coords)

    def can_quantize(self) -> bool:
        """Whether a ladder step down may pick this tenant: not demoted, not
        on the last quantized rung, no coordinate staged in row blocks or
        row-sharded over cards, and a single-tier random-effect matrix left
        to shrink."""
        if self.demoted or self.tier == PRECISION_LADDER[-1]:
            return False
        st = self.engine._state
        if any(c.row_blocks is not None or c.mesh is not None for c in st.coords):
            return False
        return any(kind in ("re", "re_bf16") for kind in st.kinds)

    def signature(self, state=None) -> Optional[tuple]:
        """The co-batch key of this tenant's (or `state`'s) generation, or
        None when it dispatches solo."""
        return _signature(self.engine.task, self.engine._state if state is None else state)


class TenantRegistry:
    """N named tenants on one card (module docstring). `admit()` stages a
    tenant, `submit(name, request)` routes one request, `close()` drains and
    joins every thread."""

    def __init__(self, *, max_batch: Optional[int] = None, max_wait_ms: Optional[float] = None,
                 hbm_budget_bytes: Optional[int] = None,
                 watchdog_ms_override: Optional[float] = None):
        # Both batching quantities are planned: explicit arguments win, else
        # the installed plan's, else the defaults (the engine's and the
        # batcher's deferral).
        from photon_ml_tpu_torch import planner

        max_batch = int(planner.planned_value("serving_max_batch") if max_batch is None else max_batch)
        max_wait_ms = float(planner.planned_value("serving_max_wait_ms") if max_wait_ms is None
                            else max_wait_ms)
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.buckets = _bucket_sizes(self.max_batch)
        self._hbm_budget_override = hbm_budget_bytes
        self._watchdog_ms = float(watchdog_ms()) if watchdog_ms_override is None \
            else float(watchdog_ms_override)
        self._watchdog = Watchdog()
        self._cv = threading.Condition()
        self._tenants: Dict[str, Tenant] = {}
        self._order = 0
        self._rr = 0  # the weighted-fair rotation cursor
        self._stop = False
        self._unhealthy: Optional[BaseException] = None
        self._service_tail_s = 0.0
        self._cobatch_dispatches = 0
        # One device mutex across every tenant engine and the co-batch
        # programs: dispatches, captures and in-place writes interleave,
        # never overlap. It also guards `_programs`.
        self._device_mutex = threading.Lock()
        self._device: Optional[torch.device] = None
        self._stream = None
        self._programs: Dict[tuple, _CobatchProgram] = {}
        self._prune = False
        self._cobatch_compiles = 0
        self._cobatch_compiles_after_warmup = 0
        self._thread = threading.Thread(target=self._dispatch_loop, name="photon-tenant-dispatch",
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ admission

    def _fleet_budget(self, device: torch.device) -> Optional[int]:
        if self._hbm_budget_override is not None:
            return int(self._hbm_budget_override)
        budget = device_memory_budget_bytes(device)
        if budget is None:
            return None
        return int(budget * float(get_knob("PHOTON_TENANT_HBM_FRACTION")))

    def admit(self, name: str, bundle, *, max_pending: Optional[int] = None,
              deadline_ms: Optional[float] = None, weight: float = 1.0, inject_faults: bool = True,
              warm: bool = True, watchdog_ms_override: Optional[float] = None) -> Tenant:
        """Stage `bundle` (a ServingBundle, or a zero-argument builder) as
        tenant `name`. The budget is enforced before the new engine pins
        anything beyond the staged bundle: while over budget, the coldest
        demotable tenant is demoted to the host tier; only a fleet that
        cannot fit after demoting every candidate refuses. Staging runs
        under the `tenant_admit` site with bounded retry; any failure
        (staging, the engine's warm-up, a co-batch capture) leaves the
        registry without the tenant and releases a builder-staged bundle
        (demotions made to fit it are kept: those tenants answer bit-equal
        from the host tier). `inject_faults=False` keeps this tenant's
        dispatches out of an armed fault plan."""
        with self._cv:
            if self._stop:
                raise RuntimeError("TenantRegistry is closed")
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already admitted")
        builder = bundle if callable(bundle) else None

        def _stage():
            faults.fault_point("tenant_admit")
            return builder() if builder is not None else bundle

        with telemetry.metric_label_scope(tenant=name):
            staged = faults.retry(_stage, label=f"tenant {name} admission")
        if staged.released:
            raise ValueError(f"tenant {name!r} bundle is already released")
        if self._device is not None and staged.device != self._device:
            if builder is not None:
                staged.release()
            raise ValueError(f"tenant {name!r} is staged on {staged.device}; the registry serves "
                             f"on {self._device}")

        # With PHOTON_TIER_LADDER on, each relief step takes the coldest
        # tenant that can step one precision rung down, before any tenant
        # goes to the host tier (fleet-wide: an int8 tenant colder than it
        # does not go to the host first).
        ladder = bool(get_knob("PHOTON_TIER_LADDER"))
        demoted: List[str] = []
        need = _bundle_device_bytes(staged)
        budget = self._fleet_budget(staged.device)
        try:
            while budget is not None:
                with self._cv:
                    have = sum(t.device_bytes() for t in self._tenants.values())
                    victims = sorted((t for t in self._tenants.values()
                                      if t.can_demote() or (ladder and t.can_quantize())),
                                     key=lambda t: (t.last_active, t.order))
                if have + need <= budget:
                    break
                if not victims:
                    raise HbmBudgetExceeded(
                        f"admitting tenant {name!r} needs {need} bytes beside {have} resident "
                        f"bytes (budget {budget}); every demotable resident tenant is already on "
                        "the host tier")
                victim = next((t for t in victims if ladder and t.can_quantize()), victims[0])
                if ladder and victim.can_quantize():
                    try:
                        self.demote_tier(victim.name, reason="hbm_pressure")
                    except TierErrorCeilingExceeded:
                        # int8 would answer outside its tolerance: the
                        # bit-equal host tier relieves this victim instead.
                        self.demote(victim.name, reason="hbm_pressure")
                else:
                    self.demote(victim.name, reason="hbm_pressure")
                demoted.append(victim.name)
        except BaseException:
            if builder is not None:
                staged.release()
            raise

        engine = None
        try:
            if self._device is None:
                self._device = staged.device
                if staged.device.type == "cuda":
                    self._stream = torch.cuda.Stream(device=staged.device)
            engine = ServingEngine(staged, max_batch=self.max_batch, inject_faults=inject_faults,
                                   device_mutex=self._device_mutex,
                                   watchdog_ms_override=watchdog_ms_override)
            if warm:
                engine.warmup()
            quota = int(get_knob("PHOTON_TENANT_MAX_PENDING")) if max_pending is None \
                else int(max_pending)
            batcher = engine.batcher(max_wait_ms=self.max_wait_s * 1e3, max_pending=quota,
                                     default_deadline_ms=deadline_ms,
                                     thread_name=f"photon-tenant-{name}-flush",
                                     metric_labels={"tenant": name})
            with self._cv:
                order = self._order
                self._order += 1
            t = Tenant(name, engine, batcher, quota=quota, deadline_ms=deadline_ms, weight=weight,
                       order=order)
            engine._prewarm_hook = lambda state, _n=name: self._prewarm_groups({_n: state})
            engine._retire_hook = self._drop_programs
            if warm:
                self._prewarm_groups({}, extra=t)
        except BaseException:
            # Not admitted: nothing may stay pinned, threaded or captured.
            if engine is not None:
                self._drop_programs(engine._state)
                engine.close()
            if builder is not None:
                staged.release()
            raise
        with self._cv:
            self._tenants[name] = t
            self._prune = True
        telemetry.emit_event("tenant_admit", tenant=name, device_bytes=int(need),
                             demoted_tenants=demoted)
        logger.info("tenant %r admitted: %.2f MB on the device%s", name, need / 1e6,
                    f" (demoted {demoted} to the host tier)" if demoted else "")
        return t

    def demote(self, name: str, *, hot_rows: int = 0, reason: str = "manual") -> int:
        """Move tenant `name`'s random effects to the host tier (`hot_rows`
        rows kept on the device). The tenant answers bit-equal throughout:
        the demoted generation pre-warms (its programs are new: the kinds
        change to "re2") before the flip, in-flight batches drain on the
        old one, and a terminal `tenant_evict` failure rolls back with the
        old generation serving. Returns the device bytes freed."""
        t = self._tenant(name)
        if t.demoted:
            return 0
        manager = t.engine.bundle_manager
        with manager.mutex:
            old_state = t.engine._state
            old_bytes = _bundle_device_bytes(old_state.bundle)

            def stage():
                def build():
                    faults.fault_point("tenant_evict")
                    return demote_bundle_to_host_tier(old_state.bundle, hot_rows=hot_rows)

                return faults.retry(build, label=f"tenant {name} demotion")

            with telemetry.metric_label_scope(tenant=name):
                manager._stage_and_commit(old_state, stage, kind="demote")
            t.demoted = True
            faults.COUNTERS.increment("tenant_demotions")
        freed = old_bytes - _bundle_device_bytes(t.engine.bundle)
        telemetry.emit_event("tenant_evict", tenant=name, reason=reason, freed_bytes=int(freed),
                             hot_rows=int(hot_rows))
        logger.info("tenant %r demoted to the host tier (%s): %.2f MB freed", name, reason,
                    freed / 1e6)
        return int(freed)

    def restore(self, name: str, *, reason: str = "manual") -> int:
        """Bring a demoted tenant's random effects back onto the device (the
        inverse of `demote`, bit-equal: the matrices are the cold tier's
        rows, a quantized tenant's original ones), through the same
        pre-warm, flip and drain; the tenant is on the f32 rung after it.
        Returns the device bytes re-pinned (0 if not demoted)."""
        t = self._tenant(name)
        if not t.demoted:
            return 0
        manager = t.engine.bundle_manager
        with manager.mutex:
            old_state = t.engine._state
            old_bytes = _bundle_device_bytes(old_state.bundle)

            def stage():
                return faults.retry(lambda: promote_bundle_from_host_tier(old_state.bundle),
                                    label=f"tenant {name} restore")

            with telemetry.metric_label_scope(tenant=name):
                manager._stage_and_commit(old_state, stage, kind="restore")
            t.demoted = False
            t.tier = "f32"
            faults.COUNTERS.increment("tenant_restores")
        repinned = _bundle_device_bytes(t.engine.bundle) - old_bytes
        telemetry.emit_event("tenant_restore", tenant=name, reason=reason,
                             device_bytes=int(repinned))
        logger.info("tenant %r restored to the device (%s): %.2f MB re-pinned", name, reason,
                    repinned / 1e6)
        return int(repinned)

    def demote_tier(self, name: str, *, to: Optional[str] = None, reason: str = "manual") -> int:
        """Walk tenant `name` down the precision ladder, f32 -> bf16 -> int8
        -> host: one rung, or to the rung `to` ("bf16", "int8", "host"). A
        quantized step runs its build under the `quantize_stage` site with
        bounded retry; a terminal failure leaves the old generation serving
        (`tier_rollbacks`). An int8 step past PHOTON_TIER_INT8_ERROR_CEILING
        raises `TierErrorCeilingExceeded` before the commit; walking past it
        to "host" skips the refused rung. The host rung is `demote()`, built
        from the original float32 rows. Returns the device bytes freed."""
        t = self._tenant(name)
        ladder = (*PRECISION_LADDER, "host")
        if to is not None and to not in ladder[1:]:
            raise ValueError(f"unknown precision rung {to!r} (ladder: {ladder[1:]})")
        if t.demoted:
            return 0
        idx = ladder.index(t.tier)
        tgt = idx + 1 if to is None else ladder.index(to)
        freed = 0
        for rung in ladder[idx + 1: tgt + 1]:
            if rung == "host":
                freed += self.demote(name, reason=reason)
                continue
            try:
                freed += self._tier_step(t, rung, reason, down=True)
            except TierErrorCeilingExceeded:
                if tgt > ladder.index(rung):
                    continue  # the host rung below is bit-equal: keep descending
                raise
        return int(freed)

    def restore_tier(self, name: str, *, to: str = "f32", reason: str = "manual") -> int:
        """Walk tenant `name` back up toward the rung `to` (default f32):
        host -> int8 -> bf16 -> f32, a rung a step, the host rung by
        `restore()` (which lands on f32). A quantized step's build runs
        under the `tier_restore` site with bounded retry; the step to f32 is
        bit-equal, and int8 -> bf16 rounds the same original rows again.
        Returns the device bytes re-pinned."""
        t = self._tenant(name)
        if to not in PRECISION_LADDER:
            raise ValueError(f"unknown precision rung {to!r} (ladder: {PRECISION_LADDER})")
        repinned = 0
        if t.demoted:
            repinned += self.restore(name, reason=reason)
        tgt = PRECISION_LADDER.index(to)
        while PRECISION_LADDER.index(t.tier) > tgt:
            rung = PRECISION_LADDER[PRECISION_LADDER.index(t.tier) - 1]
            repinned += self._tier_step(t, rung, reason, down=False)
        return int(repinned)

    def _tier_step(self, t: Tenant, rung: str, reason: str, *, down: bool) -> int:
        """One committed rung, down (quantize) or up (toward f32), through
        the engine's BundleManager under its mutex (a swap and a ladder step
        order, never race): build, the int8 ceiling, pre-warm of the new
        kind's programs, commit, drain. Returns the bytes freed (down) or
        re-pinned (up)."""
        from_tier = t.tier
        manager = t.engine.bundle_manager
        errors: Dict[str, float] = {}
        with manager.mutex:
            old_state = t.engine._state
            old_bytes = _bundle_device_bytes(old_state.bundle)

            def build():
                if down:
                    faults.fault_point("quantize_stage")
                else:
                    faults.fault_point("tier_restore")
                if rung == "f32":
                    return restore_bundle_precision(old_state.bundle), {}
                return quantize_bundle_rows(old_state.bundle, rung)

            def stage():
                bundle, errs = faults.retry(build, label=f"tenant {t.name} {rung} "
                                            + ("quantization" if down else "restore"))
                err_max = max(errs.values(), default=0.0)
                ceiling = float(get_knob("PHOTON_TIER_INT8_ERROR_CEILING"))
                if down and rung == "int8" and err_max > ceiling:
                    bundle.release(close_stores=False)
                    raise TierErrorCeilingExceeded(
                        f"tenant {t.name!r}: int8 round-trip error {err_max:.4g} exceeds the "
                        f"PHOTON_TIER_INT8_ERROR_CEILING of {ceiling}; staying at {from_tier!r}")
                for err in errs.values():
                    telemetry.METRICS.observe("tier_quant_error", err)  # labelled by the tenant
                errors.update(errs)
                return bundle

            with telemetry.metric_label_scope(tenant=t.name):
                try:
                    info = manager._stage_and_commit(old_state, stage,
                                                     kind="tier_demote" if down else "tier_restore")
                except BaseException:
                    # Nothing committed: the old generation never stopped serving.
                    t.tier_rollbacks += 1
                    faults.COUNTERS.increment("tier_rollbacks")
                    raise
                t.tier = rung
                if errors:
                    t.quant_error_max = max(t.quant_error_max or 0.0, max(errors.values()))
                if down:
                    t.tier_demotions += 1
                    faults.COUNTERS.increment("tier_demotions")
                else:
                    t.tier_restores += 1
                    faults.COUNTERS.increment("tier_restores")
            moved = info["staged_bytes"] - old_bytes  # the staged bundle's device bytes
        if down:
            telemetry.emit_event("tier_demote", tenant=t.name, from_tier=from_tier, to_tier=rung,
                                 reason=reason, freed_bytes=int(-moved),
                                 evidence={"quant_error_max": max(errors.values(), default=0.0),
                                           "quantized_coordinates": len(errors)})
        else:
            telemetry.emit_event("tier_restore", tenant=t.name, from_tier=from_tier, to_tier=rung,
                                 reason=reason, repinned_bytes=int(moved),
                                 evidence={"quantized_coordinates": len(errors)})
        logger.info("tenant %r stepped %s the precision ladder %s -> %s (%s): %.2f MB %s", t.name,
                    "down" if down else "up", from_tier, rung, reason, abs(moved) / 1e6,
                    "freed" if down else "re-pinned")
        return int(-moved if down else moved)

    def retune(self, *, max_wait_ms: Optional[float] = None) -> Dict[str, float]:
        """Move the co-batched path's flush wait live (the autopilot's retune
        actuator). Only the wait moves: the bucket ladder is captured state,
        so no graph is captured. Returns the displaced value for a
        rollback."""
        with self._cv:
            prev = {"max_wait_ms": self.max_wait_s * 1e3}
            if max_wait_ms is not None:
                if max_wait_ms < 0:
                    raise ValueError("max_wait_ms must be >= 0")
                self.max_wait_s = float(max_wait_ms) / 1e3
                self._cv.notify_all()
        return prev

    # ------------------------------------------------- co-batch programs

    def _groups(self, tenants: Sequence[Tenant], states: Dict[str, object]) -> Dict[tuple, list]:
        """signature -> [(tenant, state)] in admission order."""
        groups: Dict[tuple, list] = {}
        for t in sorted(tenants, key=lambda t: t.order):
            st = states[t.name]
            sig = t.signature(st)
            if sig is not None:
                groups.setdefault(sig, []).append((t, st))
        return groups

    @staticmethod
    def _key(sig: tuple, members: Sequence[tuple], bucket: int) -> tuple:
        return (sig, tuple((t.name, st.generation) for t, st in members), bucket)

    def _build_program(self, sig, members, bucket) -> _CobatchProgram:
        """Under the device mutex."""
        prog = _CobatchProgram(sig, [st for _, st in members], bucket, self._device)
        self._cobatch_compiles += 1
        return prog

    def _prewarm_groups(self, changes: Dict[str, object], *, extra: Optional[Tenant] = None,
                        removed: Sequence[str] = ()) -> int:
        """Capture every bucket's program of each co-batch group as it will
        be once `changes` (tenant -> its next state) commit, `extra` joins
        and `removed` leaves; programs already built are kept. Returns the
        captures made; a failed capture raises."""
        with self._cv:
            tenants = [t for t in self._tenants.values() if t.name not in removed]
        if extra is not None:
            tenants.append(extra)
        states = {t.name: changes.get(t.name, t.engine._state) for t in tenants}
        made = 0
        for sig, members in self._groups(tenants, states).items():
            for b in self.buckets:
                key = self._key(sig, members, b)
                with self._device_mutex:
                    if key not in self._programs:
                        self._programs[key] = self._build_program(sig, members, b)
                        made += 1
        return made

    def _drop_programs(self, state) -> None:
        """Drop every program captured with `state`, a generation that will
        never serve again: no round holds it (a retired one has drained, a
        rolled-back or failed one never served), so this runs at once."""
        with self._device_mutex:
            for key in [k for k in self._programs
                        if any(gen == state.generation for _, gen in k[1])]:
                del self._programs[key]

    def _prune_programs(self) -> None:
        """Drop the programs of groups whose membership changed (a member
        left or joined). Runs on the dispatch thread, between rounds, so no
        round loses the program it snapshotted."""
        with self._cv:
            if not self._prune:
                return
            self._prune = False
            tenants = list(self._tenants.values())
        live = {self._key(sig, members, 0)[:2]
                for sig, members in self._groups(tenants, {t.name: t.engine._state
                                                           for t in tenants}).items()}
        with self._device_mutex:
            for key in [k for k in self._programs if k[:2] not in live]:
                del self._programs[key]

    # -------------------------------------------------------------- scoring

    def _tenant(self, name: str) -> Tenant:
        with self._cv:
            t = self._tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r} (admitted: {sorted(self._tenants)})")
        return t

    def submit(self, name: str, request: ScoreRequest, *, block: bool = False,
               deadline_ms: Optional[float] = None) -> "Future[ScoreResult]":
        """Enqueue one request for tenant `name`. Sheds with `Overloaded`
        naming the tenant once its quota is full (`block=True` waits
        instead); the deadline defaults per request, then per tenant.
        Co-batch-eligible tenants ride the registry's dispatch; the others
        go straight to their own micro-batcher."""
        t = self._tenant(name)
        fut: "Future[ScoreResult]" = Future()
        now = time.monotonic()
        budget_ms = deadline_ms if deadline_ms is not None else (
            request.deadline_ms if request.deadline_ms is not None else t.deadline_ms)
        expiry = None if budget_ms is None else now + budget_ms / 1e3
        with telemetry.metric_label_scope(tenant=name):
            eligible = t.signature() is not None
            with self._cv:
                first_pass = True
                while True:
                    if self._stop:
                        raise RuntimeError("TenantRegistry is closed")
                    if self._unhealthy is not None:
                        raise BatcherUnhealthy(f"tenant dispatch thread died: {self._unhealthy!r}") \
                            from self._unhealthy
                    if t.draining:
                        raise KeyError(f"tenant {name!r} is being removed; no new submits accepted "
                                       "while it drains")
                    if first_pass and eligible:
                        # One admission fault per submit, behind the tenant's
                        # gate (the micro-batcher fires its own on the direct
                        # path).
                        first_pass = False
                        try:
                            if t.engine.inject_faults:
                                faults.fault_point("admit")
                        except faults.InjectedFault as exc:
                            t.shed += 1
                            faults.COUNTERS.increment("serving_shed_requests")
                            raise Overloaded(f"admission fault injected: {exc}", tenant=name) from exc
                    if t.in_flight < t.quota:
                        break
                    if not block:
                        t.shed += 1
                        faults.COUNTERS.increment("serving_shed_requests")
                        raise Overloaded(f"tenant {name!r} pending quota full ({t.quota} requests); "
                                         "shed by per-tenant admission control", tenant=name)
                    self._cv.wait()
                t.in_flight += 1
                t.last_active = now
                if eligible:
                    t.queue.append((request, fut, now, expiry))
                    self._cv.notify_all()
            if not eligible:
                self._submit_direct(t, request, fut, now, expiry, block)
        return fut

    def score(self, name: str, request: ScoreRequest) -> ScoreResult:
        return self.submit(name, request, block=True).result()

    def _submit_direct(self, t: Tenant, request: ScoreRequest, fut: Future, t0: float,
                       expiry: Optional[float], block: bool) -> None:
        """The solo path: the tenant's own micro-batcher, its future chained
        to the registry's."""
        remaining = None if expiry is None else max(0.0, (expiry - time.monotonic()) * 1e3)
        try:
            inner = t.batcher.submit(request, block=block, deadline_ms=remaining)
        except Overloaded as exc:
            self._resolve(t, fut, None, t0, error=Overloaded(str(exc), tenant=t.name))
            return
        except BaseException as exc:  # surfaced through the future
            self._resolve(t, fut, None, t0, error=exc)
            return
        self._chain(t, fut, inner, t0)

    def _chain(self, t: Tenant, fut: Future, inner: Future, t0: float) -> None:
        def _done(inner_fut: Future) -> None:
            exc = inner_fut.exception()
            if exc is not None:
                if isinstance(exc, Overloaded) and exc.tenant is None:
                    exc = Overloaded(str(exc), tenant=t.name)
                elif isinstance(exc, DeadlineExceeded) and exc.tenant is None:
                    exc = DeadlineExceeded(str(exc), tenant=t.name)
                self._resolve(t, fut, None, t0, error=exc)
            else:
                self._resolve(t, fut, inner_fut.result(), t0)

        inner.add_done_callback(_done)

    def _resolve(self, t: Tenant, fut: Future, result: Optional[ScoreResult], t0: float, *,
                 error: Optional[BaseException] = None, cobatched: bool = False) -> None:
        """The one completion path of every route: the tenant's latency and
        counters, its in-flight slot (waking blocked submitters), the
        future."""
        wall_ms = (time.monotonic() - t0) * 1e3
        with self._cv:
            t.in_flight -= 1
            if error is None:
                t.completed += 1
                t.latency.record(wall_ms)
                if cobatched:
                    t.cobatched += 1
            else:
                if isinstance(error, DeadlineExceeded):
                    t.deadline_missed += 1
                elif isinstance(error, Overloaded):
                    t.shed += 1
                t.failed += 1
            self._cv.notify_all()
        self._note_health(t)
        if fut.done():
            return
        if error is None:
            # Labelled: the aggregate series and the tenant's own, whose p95
            # the autopilot reads.
            telemetry.METRICS.observe("serving_latency_ms", wall_ms, labels=(("tenant", t.name),))
            fut.set_result(result)
        else:
            fut.set_exception(error)

    def _note_health(self, t: Tenant) -> None:
        """Journal a tenant's new degradation reasons (`tenant_degraded`)."""
        reasons = tuple(t.engine.health.degraded_reasons)
        if reasons and reasons != t._seen_reasons:
            new = [r for r in reasons if r not in t._seen_reasons]
            if new:
                telemetry.emit_event("tenant_degraded", tenant=t.name, reasons=new)
        t._seen_reasons = reasons

    # --------------------------------------------------------- dispatch loop

    def _dispatch_loop(self) -> None:
        try:
            self._dispatch_loop_inner()
        except BaseException as exc:  # the thread's last guard
            logger.error("tenant dispatch thread died: %r", exc)
            faults.COUNTERS.increment("serving_flush_thread_failures")
            with self._cv:
                self._unhealthy = exc
                doomed: List[Tuple[Tenant, _Pending]] = []
                for t in self._tenants.values():
                    while t.queue:
                        doomed.append((t, t.queue.popleft()))
                self._cv.notify_all()
            for t, (_, fut, t0, _) in doomed:
                if fut.set_running_or_notify_cancel():
                    self._resolve(t, fut, None, t0, error=exc)
            for t in list(self._tenants.values()):
                t.engine.health.add_degraded(f"tenant_dispatch_dead: {exc!r}")

    def _dispatch_loop_inner(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._ripe_locked():
                    self._cv.wait(timeout=self._wait_timeout_locked())
                if self._stop and not any(t.queue for t in self._tenants.values()):
                    return
                claimed, expired = self._claim_locked()
                self._cv.notify_all()
            self._prune_programs()
            for t, fut, t0 in expired:
                with telemetry.metric_label_scope(tenant=t.name):
                    faults.COUNTERS.increment("serving_deadline_misses")
                self._resolve(t, fut, None, t0, error=DeadlineExceeded(
                    "request expired in the tenant queue before batch assembly", tenant=t.name))
            if not claimed:
                continue
            # Partition by signature; each partition is one dispatch (a
            # tenant whose signature changed since submit goes solo).
            groups: Dict[tuple, List[Tuple[Tenant, _Pending]]] = {}
            stale: List[Tuple[Tenant, _Pending]] = []
            for t, item in claimed:
                sig = t.signature()
                if sig is None:
                    stale.append((t, item))
                else:
                    groups.setdefault(sig, []).append((t, item))
            for t, item in stale:
                self._fallback(t, [item])
            for sig, items in groups.items():
                self._dispatch_cobatch(sig, items)

    def _ripe_locked(self) -> bool:
        now = time.monotonic()
        pending = 0
        for t in self._tenants.values():
            if not t.queue:
                continue
            pending += sum(not item[1].cancelled() for item in t.queue)  # live ones, as the batcher
            front = t.queue[0]
            if front[3] is not None and now >= front[3]:
                return True  # an expired head: claim it to fail it promptly
            if (now - front[2]) >= self.max_wait_s:
                return True
        return pending >= self.max_batch

    def _wait_timeout_locked(self) -> Optional[float]:
        wake: Optional[float] = None
        for t in self._tenants.values():
            if not t.queue:
                continue
            front = t.queue[0]
            w = front[2] + self.max_wait_s
            if front[3] is not None:
                w = min(w, front[3])
            wake = w if wake is None else min(wake, w)
        if wake is None:
            return None
        return max(0.0, wake - time.monotonic())

    def _claim_locked(self):
        """Weighted-fair claim: up to max_batch slots split over the
        backlogged tenants by weight (each at least one), the start rotated
        so equal weights alternate who claims first; leftover slots go round
        robin. Expired and cancelled requests are filtered here."""
        now = time.monotonic()
        horizon = now + self._service_tail_s
        backlogged = [t for t in self._tenants.values() if t.queue]
        claimed: List[Tuple[Tenant, _Pending]] = []
        expired: List[Tuple[Tenant, Future, float]] = []
        if not backlogged:
            return claimed, expired
        start = self._rr % len(backlogged)
        self._rr += 1
        order = backlogged[start:] + backlogged[:start]
        slots = self.max_batch
        total_w = sum(t.weight for t in order) or 1.0

        def _take(t: Tenant, n: int) -> int:
            took = 0
            while took < n and t.queue:
                item = t.queue.popleft()
                if not item[1].set_running_or_notify_cancel():
                    # Cancelled while queued: _resolve never runs for it, so
                    # its quota slot is released here.
                    t.in_flight -= 1
                    continue
                if item[3] is not None and horizon >= item[3]:
                    expired.append((t, item[1], item[2]))
                    continue
                claimed.append((t, item))
                took += 1
            return took

        for t in order:
            if slots <= 0:
                break
            share = max(1, int(self.max_batch * t.weight / total_w))
            slots -= _take(t, min(share, slots))
        while slots > 0:
            progressed = False
            for t in order:
                if slots <= 0:
                    break
                got = _take(t, 1)
                slots -= got
                progressed = progressed or bool(got)
            if not progressed:
                break
        if expired and not claimed:
            # No dispatch re-measures the service time: decay it.
            self._service_tail_s *= 0.5
        return claimed, expired

    def _fallback(self, t: Tenant, items: Sequence[_Pending], *, degraded: bool = False) -> None:
        """Route claimed items to the tenant's own micro-batcher (its retry,
        FE-only and circuit policy): stale signatures, open circuits,
        injected faults and whole co-batch failures. Only this tenant's
        items move."""
        with telemetry.metric_label_scope(tenant=t.name):
            if degraded:
                t.cobatch_degraded += 1
                faults.COUNTERS.increment("serving_degraded_batches")
            now = time.monotonic()
            for req, fut, t0, expiry in items:
                if expiry is not None and now >= expiry:
                    self._resolve(t, fut, None, t0, error=DeadlineExceeded(
                        "request expired before its co-batch fallback", tenant=t.name))
                    continue
                remaining = None if expiry is None else (expiry - now) * 1e3
                try:
                    inner = t.batcher.submit(req, block=False, deadline_ms=remaining)
                except Overloaded as exc:
                    self._resolve(t, fut, None, t0, error=Overloaded(str(exc), tenant=t.name))
                except BaseException as exc:  # surfaced through the future
                    self._resolve(t, fut, None, t0, error=exc)
                else:
                    self._chain(t, fut, inner, t0)

    def _dispatch_cobatch(self, sig: tuple, items: List[Tuple[Tenant, _Pending]]) -> None:
        """One cross-tenant dispatch. The group is every tenant whose
        current generation has the signature (an idle member still brings
        its planes: the program's shapes stay put); each member's state is
        held (`active`) until the dispatch returns, so a flip's drain waits
        for it. Per-tenant fault sites degrade only that tenant's slice; a
        whole-dispatch failure degrades every slice to its own tenant's
        batcher."""
        with self._cv:
            tenants = sorted(self._tenants.values(), key=lambda t: t.order)
        members: List[Tenant] = []
        states: Dict[str, object] = {}
        for t in tenants:
            with t.engine._lock:
                st = t.engine._state
                if t.signature(st) != sig:
                    continue
                st.active += 1
            members.append(t)
            states[t.name] = st
        try:
            self._dispatch_members(sig, members, states, items)
        finally:
            for t in members:
                with t.engine._lock:
                    states[t.name].active -= 1
                    t.engine._lock.notify_all()

    def _dispatch_members(self, sig, members, states, items) -> None:
        member_index = {t.name: j for j, t in enumerate(members)}
        by_tenant: Dict[str, Tuple[Tenant, List[_Pending]]] = {}
        for t, item in items:
            by_tenant.setdefault(t.name, (t, []))[1].append(item)
        live: List[Tuple[Tenant, List[_Pending]]] = []
        permits: Dict[str, object] = {}
        for name, (t, t_items) in by_tenant.items():
            if name not in member_index:
                self._fallback(t, t_items)
                continue
            permit = t.engine.breaker.acquire()
            if permit is None:
                self._fallback(t, t_items)  # circuit open: FE-only answers there
                continue
            permits[name] = permit
            live.append((t, t_items))
        if not live:
            return
        # Per-tenant lookup: a fault fires in its tenant's label scope and
        # degrades only that tenant's slice.
        packed: List[Tuple[Tenant, _Pending, int, List[int]]] = []
        survivors: List[Tuple[Tenant, List[_Pending]]] = []
        for t, t_items in live:
            st = states[t.name]
            try:
                with telemetry.metric_label_scope(tenant=t.name):
                    if t.engine.inject_faults:
                        faults.fault_point("lookup")
                        faults.fault_point("score")
                    rows_cold = self._lookup_tenant(st, t_items)
            except faults.InjectedFault:
                t.engine.breaker.on_abandon(permits.pop(t.name))
                self._fallback(t, t_items, degraded=True)
                continue
            survivors.append((t, t_items))
            for item, rc in zip(t_items, rows_cold):
                packed.append((t, item, member_index[t.name], rc))
        if not packed:
            return
        n = len(packed)
        bucket = next(b for b in self.buckets if b >= n)  # a round claims at most max_batch
        t_d = time.monotonic()
        try:
            total, means, cold_flags = self._pack_and_dispatch(sig, members, states, packed, bucket,
                                                               survivors)
        except BaseException as exc:  # isolated: each tenant's solo path judges its own
            logger.warning("co-batch of %d across %d tenant(s) degraded to solo dispatch: %s", n,
                           len(survivors), exc)
            for t, t_items in survivors:
                t.engine.breaker.on_abandon(permits.pop(t.name))
                self._fallback(t, t_items, degraded=True)
            return
        t_done = time.monotonic()
        with self._cv:
            self._cobatch_dispatches += 1
            self._service_tail_s = max(t_done - t_d, 0.9 * self._service_tail_s)
        faults.COUNTERS.increment("tenant_cobatch_dispatches")
        for t, _ in survivors:
            t.engine.breaker.on_success(permits.pop(t.name))
        for i, (t, item, _, rc) in enumerate(packed):
            flags = cold_flags[i]
            res = ScoreResult(score=float(total[i]), mean=float(means[i]), uid=item[0].uid,
                              cold_start=bool(flags.any()), n_cold=int(flags.sum()), fe_only=False)
            self._resolve(t, item[1], res, item[2], cobatched=True)

    def _pack_and_dispatch(self, sig, members, states, packed, bucket, survivors):
        """Assemble the shared bucket (a feature buffer per coordinate, a row
        vector per random effect and member, the tenant ids) and run one
        dispatch. Raises on any failure, a malformed payload included; the
        caller degrades the slices, so nothing here kills the thread."""
        task, kinds, dims = sig
        offsets = np.zeros(bucket, np.float32)
        tids = np.zeros(bucket, np.int64)
        feats = [np.zeros((bucket, d), np.float32) for d in dims]
        re_positions = [k for k, kind in enumerate(kinds) if kind == "re"]
        rows = {k: [np.full(bucket, states[m.name].coords[k].unseen_row, np.int64) for m in members]
                for k in re_positions}
        cold_flags = np.zeros((bucket, len(re_positions)), bool)
        for i, (t, item, tj, rc) in enumerate(packed):
            req = item[0]
            offsets[i] = req.offset
            tids[i] = tj
            st = states[t.name]
            for k, c in enumerate(st.coords):
                payload = req.features.get(c.shard)
                if payload is None:
                    continue
                if isinstance(payload, tuple):
                    idx, vals = payload
                    np.add.at(feats[k][i], np.asarray(idx, np.int64), vals)
                else:
                    feats[k][i, :] = payload
            for j, k in enumerate(re_positions):
                rows[k][tj][i] = rc[j]
                cold_flags[i, j] = rc[j] == st.coords[k].unseen_row
        group = [(m, states[m.name]) for m in members]
        key = self._key(sig, group, bucket)
        with telemetry.span("tenant_cobatch", size=len(packed), bucket=bucket,
                            tenants=[t.name for t, _ in survivors]):
            with self._watchdog.guard(self._watchdog_ms, f"tenant co-batch dispatch (bucket {bucket})"):
                with self._device_mutex:
                    prog = self._programs.get(key)
                    if prog is None:
                        # Not pre-warmed: a capture on the dispatch path.
                        prog = self._programs[key] = self._build_program(sig, group, bucket)
                        self._cobatch_compiles_after_warmup += 1
                    total, means = prog.run(offsets, tids, feats, rows, self._stream)
        return total, means, cold_flags

    @staticmethod
    def _lookup_tenant(state, t_items) -> List[List[int]]:
        """One tenant's claimed items -> rows per random-effect position."""
        out: List[List[int]] = [[] for _ in t_items]
        for c in state.coords:
            if not c.is_random_effect:
                continue
            resolved, _ = c.lookup_rows([item[0].entity_ids.get(c.random_effect_type)
                                         for item in t_items])
            if c.shard_health is not None:
                c.shard_health.record_loads(resolved, c.unseen_row)
            for i, r in enumerate(resolved):
                out[i].append(int(r))
        return out

    # -------------------------------------------------------------- metrics

    def metrics(self) -> Dict[str, object]:
        """Co-batch accounting and one TENANT_BLOCK_KEYS block per tenant
        (every key present; the `tier` sub-block, TIER_BLOCK_KEYS, is the
        tenant's rung and ladder history)."""
        with self._cv:
            tenants = list(self._tenants.values())
            cobatch = self._cobatch_dispatches
        with self._device_mutex:
            compiles, lazy = self._cobatch_compiles, self._cobatch_compiles_after_warmup
        wd_labeled = telemetry.METRICS.labeled_counters("watchdog_trips")
        out: Dict[str, object] = {
            "n_tenants": len(tenants),
            "max_batch": self.max_batch,
            "cobatch_dispatches": cobatch,
            "cobatch_compiles": compiles,
            "cobatch_compiles_after_warmup": lazy,
            "tenants": {},
        }
        for t in tenants:
            bm = t.batcher.metrics()
            health = t.engine.health.snapshot()

            def pct(q, _t=t):
                return round(float(_t.latency.percentile(q)), 4) if _t.latency.count else None

            block = {
                "completed": t.completed,
                "failed": t.failed,
                # Registry-side tallies: every shed and deadline resolves
                # through the registry's future.
                "shed": t.shed,
                "deadline_missed": t.deadline_missed,
                "fe_only_answers": int(bm["fe_only_answers"]),
                "degraded_batches": t.cobatch_degraded + int(bm["degraded_batches"]),
                "cobatched_requests": t.cobatched,
                "p50_ms": pct(50.0),
                "p95_ms": pct(95.0),
                "p99_ms": pct(99.0),
                "state": health["state"],
                "degraded_reasons": health["degraded_reasons"],
                "circuit_state": t.engine.breaker.snapshot()["circuit_state"],
                "demoted": t.demoted,
                "device_bytes": t.device_bytes(),
                "watchdog_trips": int(wd_labeled.get(f"tenant={t.name}", 0)),
                "tier": dict(zip(TIER_BLOCK_KEYS, (
                    t.tier, sum(k in ("re_bf16", "re_i8") for k in t.engine._state.kinds),
                    t.tier_demotions, t.tier_restores, t.tier_rollbacks, t.quant_error_max))),
            }
            assert tuple(block) == TENANT_BLOCK_KEYS
            out["tenants"][t.name] = block
        return out

    # ------------------------------------------------------------ lifecycle

    @property
    def tenant_names(self) -> List[str]:
        with self._cv:
            return list(self._tenants)

    def tenant(self, name: str) -> Tenant:
        return self._tenant(name)

    def remove(self, name: str, *, release_bundle: bool = False,
               drain_timeout_s: float = 30.0) -> None:
        """Retire one tenant while the others keep serving. New submits are
        refused at once; its queued and in-flight requests are answered;
        the programs of its group without it are captured; then its engine
        closes and its bundle is released if asked. A tenant that does not
        drain in time raises and stays admitted."""
        t = self._tenant(name)
        deadline = time.monotonic() + drain_timeout_s
        with self._cv:
            t.draining = True
            self._cv.notify_all()
            while t.queue or t.in_flight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    t.draining = False
                    raise RuntimeError(f"tenant {name!r} did not drain within {drain_timeout_s}s "
                                       f"({len(t.queue)} queued, {t.in_flight} in flight); "
                                       "still admitted")
                self._cv.wait(timeout=remaining)
        try:
            self._prewarm_groups({}, removed=(name,))
        except BaseException:
            with self._cv:
                t.draining = False
            raise
        with self._cv:
            del self._tenants[name]
            self._prune = True
        t.engine._prewarm_hook = t.engine._retire_hook = None
        t.engine.close()
        if release_bundle and not t.engine._state.bundle.released:
            t.engine._state.bundle.release()

    def close(self, release_bundles: bool = False) -> None:
        """Answer what is queued, join the dispatch thread, close every
        tenant's engine (its batcher and watchdog join there) and the
        registry's watchdog. Idempotent."""
        with self._cv:
            if self._stop:
                return
            self._stop = True
            self._cv.notify_all()
        self._thread.join()
        with self._cv:
            tenants = list(self._tenants.values())
        for t in tenants:
            t.engine.close()
            if release_bundles and not t.engine._state.bundle.released:
                t.engine._state.bundle.release()
        with self._device_mutex:
            self._programs.clear()
        self._watchdog.close()

    def __enter__(self) -> "TenantRegistry":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
