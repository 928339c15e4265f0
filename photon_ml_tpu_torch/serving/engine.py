"""Online scoring engine: one bucket program per power-of-two batch size
over a pinned bundle.

Port of `photon_ml_tpu/serving/engine.py`, single device:

  * The program set is bounded and declared up front: one program per
    power-of-two bucket up to `max_batch` (the planner's
    `serving_max_batch`: 256 with no plan installed). A batch of n
    requests pads to the smallest bucket >= n. `warmup()` builds every
    bucket's program; afterwards a request stream builds none
    (`recompiles_after_warmup`, 0).
  * On the card a bucket program is a CUDA graph, captured once per
    (bundle generation, bucket) on a side stream under the device mutex.
    Its inputs are static device buffers (offsets, one (bucket, d) buffer
    per feature shard, one row vector per random effect) that each dispatch
    fills from pinned host buffers by asynchronous copies; its outputs,
    (margin, mean), come back to the host in one copy. A capture that fails
    raises: there is no eager path on the card. On the CPU the same program
    runs eagerly on the same static buffers, and `compiles` counts the
    programs built.
  * The program sums `dense_margins` and `random_effect_margins` (the
    transformer's own functions, whose `row_sum` depends on the width
    alone) in coordinate order after the offsets, so a request scores to
    the same bits in any bucket, and as `GameTransformer.transform` scores
    the same row of a dense dataset.
  * Cold start: an entity the bundle does not know gathers the pinned zero
    row and scores with the fixed effects (+ offset) only.
  * Every batch runs on one `_EngineState` snapshot; `BundleManager.swap`
    flips it between batches and drains the old one. The device mutex
    serializes uploads, graph replays, fetches, captures, in-place
    restages and two-tier promotions (a captured graph reads the planes at
    fixed addresses). `device_mutex=` shares one mutex across engines (the
    multi-tenant registry's tenants on one card).
  * `score_batch_fe_only` is the circuit-open tier: every random-effect
    row at the pinned zero row, on the same program, with no fault site.

Fault sites: `lookup` (entity-row resolution) and `score` (the dispatch),
both behind the engine's `inject_faults` gate (a chaos drill confines an
armed plan to one tenant's engine). The engine raises; retry, per-request
fallback and circuit routing live in the batcher. The watchdog guards
live-traffic dispatches only.

Kinds: "fe" (weight vector), "re" (single-tier matrix) and "re2" (the
two-tier store: rows resolve against the hot plane, and cold hits are
overridden by the rows the pack copied out of host RAM, two more static
buffers of the program; the override row is the matrix row, so the margin
is the single-tier one). A two-tier batch resolves its slots at the store's
`epoch`; under the device mutex, before it replays, a batch whose epoch has
moved (a promotion wrote the plane in place) resolves them again. The
reference's row-sharded and quantized kinds are ROADMAP items 9c and 10f.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.game.model import gathered_row_margins, random_effect_margins
from photon_ml_tpu_torch.ops.losses import mean_for_task
from photon_ml_tpu_torch.serving.bundle import ScoreRequest, ServingBundle, ServingCoordinate
from photon_ml_tpu_torch.serving.lifecycle import (
    BundleManager,
    CircuitBreaker,
    HealthStateMachine,
    ServingState,
)
from photon_ml_tpu_torch.transformers.game_transformer import dense_margins
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.observability import TimingRegistry, stage_scope, stage_timer
from photon_ml_tpu_torch.utils.watchdog import Watchdog, watchdog_ms

Tensor = torch.Tensor


@dataclasses.dataclass
class ScoreResult:
    """One answered request: the summed margin and the link-function mean,
    with cold-start accounting. `fe_only` marks an answer of the
    circuit-open tier (the fixed-effect-only score)."""

    score: float
    mean: float
    uid: Optional[str] = None
    cold_start: bool = False  # any random-effect lookup fell back
    n_cold: int = 0
    fe_only: bool = False
    n_lost: int = 0  # fallbacks because the row's shard is marked lost


def _score_program(offsets: Tensor, feats: Dict[str, Tensor], rows: Tuple[Optional[Tensor], ...],
                   params: Tuple[Tensor, ...], norms: tuple, overrides: tuple = (), *,
                   kinds: Tuple[str, ...], shards: Tuple[str, ...],
                   task: TaskType) -> Tuple[Tensor, Tensor]:
    """The bucket program: offsets plus each coordinate's margins, in
    coordinate order (as GameTransformer.transform sums them), and the mean.
    `overrides[k]` is a two-tier coordinate's (values, flags)."""
    total = offsets
    for k, kind in enumerate(kinds):
        f = feats[shards[k]]
        if kind == "fe":
            total = total + dense_margins(f, params[k], norms[k])
        elif kind == "re":
            total = total + random_effect_margins(f, rows[k], params[k], norms[k])
        elif kind == "re2":
            vals, flags = overrides[k]
            w = torch.where(flags[:, None], vals, params[k][rows[k]])
            total = total + gathered_row_margins(f, w, norms[k])
        else:
            raise ValueError(f"coordinate kind {kind!r} is not ported (the port serves 'fe', 're' "
                             "and 're2')")
    return total, mean_for_task(task, total)


def capture_graph(program, device: torch.device) -> Tuple["torch.cuda.CUDAGraph", Tensor]:
    """Capture `program` (no arguments; reads static buffers) as a CUDA
    graph on a side stream, after one eager run there (lazy allocations and
    library set-up stay out of the capture); returns the graph and its
    output. A failed capture raises: there is no eager path on the card.
    The caller holds the device mutex."""
    side = torch.cuda.Stream(device=device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        program()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = program()
    return graph, out


def _bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b <<= 1
    sizes.append(max_batch)
    return tuple(sizes)


class _BucketProgram:
    """One bucket's program over one engine state: static device inputs,
    pinned host staging buffers, and on the card the captured graph and its
    (2, bucket) output. Built and run under the engine's device mutex."""

    def __init__(self, state: "_EngineState", bucket: int, task: TaskType, device: torch.device):
        self.bucket = bucket
        cuda = device.type == "cuda"
        f32, i64 = torch.float32, torch.int64
        self.offsets = torch.zeros(bucket, dtype=f32, device=device)
        self.feats = {s: torch.zeros((bucket, d), dtype=f32, device=device)
                      for s, d in state.shard_dims.items()}
        # A row vector starts at the pinned zero row (a two-tier store's
        # zero slot): the capture's eager run gathers in bounds.
        self.rows = {c.cid: torch.full((bucket,), c.store.zero_slot if c.store is not None
                                       else c.unseen_row, dtype=i64, device=device)
                     for c in state.coords if c.is_random_effect}
        tiered = [c for c in state.coords if c.store is not None]
        self.ovr = {c.cid: torch.zeros((bucket, c.dim), dtype=f32, device=device) for c in tiered}
        self.ovr_flags = {c.cid: torch.zeros(bucket, dtype=torch.bool, device=device) for c in tiered}
        self.host_offsets = torch.zeros(bucket, dtype=f32, pin_memory=cuda)
        self.host_feats = {s: torch.zeros((bucket, d), dtype=f32, pin_memory=cuda)
                           for s, d in state.shard_dims.items()}
        self.host_rows = {cid: torch.zeros(bucket, dtype=i64, pin_memory=cuda) for cid in self.rows}
        self.host_ovr = {cid: torch.zeros(tuple(t.shape), dtype=f32, pin_memory=cuda)
                         for cid, t in self.ovr.items()}
        self.host_ovr_flags = {cid: torch.zeros(bucket, dtype=torch.bool, pin_memory=cuda)
                               for cid in self.ovr}
        self.host_out = torch.zeros((2, bucket), dtype=f32, pin_memory=cuda)
        params = tuple(c.params for c in state.coords)
        norms = tuple(c.norm for c in state.coords)
        rows = tuple(self.rows.get(c.cid) for c in state.coords)
        overrides = tuple((self.ovr[c.cid], self.ovr_flags[c.cid]) if c.cid in self.ovr else None
                          for c in state.coords)

        def program() -> Tensor:
            total, means = _score_program(self.offsets, self.feats, rows, params, norms, overrides,
                                          kinds=state.kinds, shards=state.coord_shards, task=task)
            return torch.stack((total, means))

        self._program = program
        self.graph, self.out = capture_graph(program, device) if cuda else (None, None)

    def nbytes(self) -> int:
        """Device bytes of the static buffers (inputs and the output)."""
        b = self.bucket
        return (4 * b + sum(4 * t.numel() for t in self.feats.values()) + 8 * b * len(self.rows) + 8 * b
                + sum(4 * t.numel() + b for t in self.ovr.values()))

    def run(self, packed: dict, stream: Optional["torch.cuda.Stream"]) -> Tuple[np.ndarray, np.ndarray]:
        """Stage `packed` into the static buffers, run, fetch (margin, mean)."""
        self.host_offsets.numpy()[:] = packed["offsets"]
        for s, buf in self.host_feats.items():
            buf.numpy()[:] = packed["buffers"][s]
        for cid, buf in self.host_rows.items():
            buf.numpy()[:] = packed["rows_by_cid"][cid]
        for cid, buf in self.host_ovr.items():
            vals, flags = packed["overrides_by_cid"][cid]
            buf.numpy()[:] = vals
            self.host_ovr_flags[cid].numpy()[:] = flags
        pairs = [(self.offsets, self.host_offsets)]
        pairs += [(buf, self.host_feats[s]) for s, buf in self.feats.items()]
        pairs += [(buf, self.host_rows[cid]) for cid, buf in self.rows.items()]
        pairs += [(buf, self.host_ovr[cid]) for cid, buf in self.ovr.items()]
        pairs += [(buf, self.host_ovr_flags[cid]) for cid, buf in self.ovr_flags.items()]
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
        out = self.host_out.numpy().copy()  # the next dispatch reuses host_out
        return out[0], out[1]


_GENERATIONS = itertools.count()


@dataclasses.dataclass
class _EngineState:
    """One bundle generation's scoring state: the bundle, its coordinates'
    kinds and shards, and its bucket programs. `active` counts in-flight
    batches (guarded by the engine lock); the swap drain waits on it."""

    bundle: ServingBundle
    coords: List[ServingCoordinate]
    kinds: Tuple[str, ...]
    coord_shards: Tuple[str, ...]
    shard_dims: Dict[str, int]
    version: int = 0
    active: int = 0
    programs: Dict[int, _BucketProgram] = dataclasses.field(default_factory=dict)
    # Unique in the process: a version repeats after a rollback or in a new
    # engine, a generation never does (the co-batch programs' key).
    generation: int = dataclasses.field(default_factory=lambda: next(_GENERATIONS))


class ServingEngine:
    """Scores request batches against a swappable pinned `ServingBundle`.

    `score_batch` may be called from any thread; each batch runs on one
    state snapshot, and device work is serialized by the device mutex.
    `compiles` counts the bucket programs this engine built."""

    def __init__(self, bundle: ServingBundle, *, max_batch: Optional[int] = None,
                 circuit_threshold: int = 5, circuit_probe_interval_s: float = 1.0,
                 watchdog_ms_override: Optional[float] = None, inject_faults: bool = True,
                 device_mutex: Optional[threading.Lock] = None):
        # A planned quantity: an explicit argument wins, else the installed
        # plan's serving_max_batch, else the default. The bucket set is the
        # power-of-two ladder up to it.
        if max_batch is None:
            from photon_ml_tpu_torch import planner

            max_batch = int(planner.planned_value("serving_max_batch"))
        max_batch = int(max_batch)
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.device = bundle.device
        self.task = bundle.task
        self.max_batch = max_batch
        self.buckets = _bucket_sizes(max_batch)
        self.stages = TimingRegistry()
        # A Condition, so the swap drain can wait for a state's in-flight
        # count to reach zero.
        self._lock = threading.Condition()
        # Shared across the engines of one card by the multi-tenant registry.
        self._device_mutex = device_mutex if device_mutex is not None else threading.Lock()
        # False excludes this engine's dispatches from an armed fault plan.
        self.inject_faults = bool(inject_faults)
        # Set by the multi-tenant registry: called with a generation's next
        # state before its commit (the co-batch captures; a raise rolls the
        # change back) and with the retired state after the drain.
        self._prewarm_hook = None
        self._retire_hook = None
        self._stream = torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        self._state = self._build_state(bundle, version=0)
        self.health = HealthStateMachine()
        self.breaker = CircuitBreaker(
            threshold=circuit_threshold, probe_interval_s=circuit_probe_interval_s,
            on_open=lambda: self.health.add_degraded("circuit_open"),
            on_close=lambda: self.health.clear_degraded("circuit_open"))
        self._bundle_manager: Optional[BundleManager] = None
        self._reshard_orchestrator = None
        self._requests = 0
        self._batches = 0
        self._lookups = 0
        self._cold_lookups = 0
        self._slots_total = 0
        self._slots_padded = 0
        self._fe_only_requests = 0
        self._shard_loss_fallbacks = 0
        self._compiles = 0
        # The hang watchdog guards live-traffic dispatches (PHOTON_WATCHDOG_MS
        # or the override; 0 = off). Warmup and the FE-only tier are exempt.
        self._watchdog_ms = float(watchdog_ms()) if watchdog_ms_override is None \
            else float(watchdog_ms_override)
        self._watchdog = Watchdog(on_trip=self._on_watchdog_trip)
        self._hang_seen = False
        self._warmup_compiles: Optional[int] = None
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._batchers: List[object] = []
        self._closed = False

    # ----------------------------------------------------------- lifecycle

    @property
    def bundle(self) -> ServingBundle:
        """The active bundle generation."""
        return self._state.bundle

    @property
    def bundle_version(self) -> int:
        return self._state.version

    @property
    def bundle_manager(self) -> BundleManager:
        with self._lock:
            if self._bundle_manager is None:
                self._bundle_manager = BundleManager(self)
            return self._bundle_manager

    @property
    def reshard_orchestrator(self):
        """This engine's placement changes on one card (created on first
        use; serving/reshard.py): the two-tier hot-row rebalance and the
        one-shard restage. A reshard across cards raises (item 9c)."""
        with self._lock:
            if self._reshard_orchestrator is None:
                from photon_ml_tpu_torch.serving.reshard import MeshReshardOrchestrator

                self._reshard_orchestrator = MeshReshardOrchestrator(self)
            return self._reshard_orchestrator

    def batcher(self, **kwargs) -> "MicroBatcher":  # noqa: F821
        """A MicroBatcher bound to this engine; `close()` joins it."""
        if self._closed:
            raise RuntimeError("ServingEngine is closed")
        from photon_ml_tpu_torch.serving.batcher import MicroBatcher

        b = MicroBatcher(self, **kwargs)
        self._batchers.append(b)
        return b

    def close(self) -> None:
        """DRAINING while every batcher made by `batcher()` answers its
        pending requests and joins its flush thread, then CLOSED. The
        bundle stays usable. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.health.begin_drain()
        for b in self._batchers:
            b.close()
        self._watchdog.close()
        self.health.close()

    def _on_watchdog_trip(self, label: str) -> None:
        self._hang_seen = True
        self.health.add_degraded("device_hang")

    def mark_shard_lost(self, cid: str, shard_index: int) -> Tuple[int, int]:
        """Mark one coefficient shard LOST: its entities answer FE-only from
        the pinned zero row and health reports DEGRADED naming the shard."""
        rng = self._state.bundle.mark_shard_lost(cid, shard_index)
        self.health.add_degraded(f"shard_loss:{cid}/{shard_index}")
        telemetry.emit_event("shard_loss", coordinate=cid, shard_index=shard_index)
        return rng

    def restage_shard(self, cid: str, shard_index: int, rows=None) -> int:
        """Recover one lost shard in place under the device mutex (no batch
        reads the planes while they are written; the captured programs stay
        valid). A final staging failure re-raises and the shard stays lost."""
        with self._device_mutex:
            nbytes = self._state.bundle.restage_shard(cid, shard_index, rows=rows)
        self.health.clear_degraded(f"shard_loss:{cid}/{shard_index}")
        telemetry.emit_event("shard_restage", coordinate=cid, shard_index=shard_index, bytes=nbytes)
        return nbytes

    def _on_batcher_unhealthy(self, exc: BaseException) -> None:
        self.health.add_degraded(f"batcher_unhealthy: {exc!r}")

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------- state plumbing

    def _build_state(self, bundle: ServingBundle, *, version: int) -> _EngineState:
        if bundle.released:
            raise RuntimeError("cannot serve a released bundle")
        if bundle.device != self.device:
            raise ValueError(f"bundle on {bundle.device} cannot serve on the engine's {self.device}")
        coords = [bundle.coordinates[cid] for cid in bundle.coordinate_ids]
        for c in coords:
            if c.store is not None:
                c.store.bind_device_mutex(self._device_mutex)
        return _EngineState(bundle=bundle, coords=coords,
                            kinds=tuple(("re2" if c.store is not None else "re")
                                        if c.is_random_effect else "fe" for c in coords),
                            coord_shards=tuple(c.shard for c in coords),
                            shard_dims=bundle.shard_dims(), version=version)

    def _warm_state(self, state: _EngineState) -> None:
        """Build every bucket program of `state` by dispatching an inert
        all-cold zero batch to each (no fault site, no request metrics);
        warmup() on the live state, the swap on the next one."""
        for b in self.buckets:
            self._dispatch(self._pack([], b, state, inject=False), state, inject=False)

    def _commit_state(self, new_state: _EngineState, *, baseline_bump: int = 0) -> _EngineState:
        """The hot-swap flip under the lock. The warmup baseline grows by the
        programs the staging built, never to the current total (which would
        hide hot-path builds)."""
        with self._lock:
            old = self._state
            self._state = new_state
            if self._warmup_compiles is not None:
                self._warmup_compiles += max(0, baseline_bump)
        return old

    def _drain_state(self, state: _EngineState, *, timeout_s: float) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while state.active > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._lock.wait(timeout=remaining)
        return True

    # ------------------------------------------------------------- scoring

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def warmup(self) -> int:
        """Build every declared bucket's program; returns the count built so
        far. Afterwards `recompiles_after_warmup` counts programs built on
        live traffic. STARTING -> READY."""
        t0 = time.perf_counter()
        self._warm_state(self._state)
        self.stages.record("serve_warmup", time.perf_counter() - t0)
        compiles = self.compiles
        with self._lock:
            self._warmup_compiles = compiles
        self.health.mark_ready()
        return compiles

    def score_batch(self, requests: Sequence[ScoreRequest], *, fe_only: bool = False) -> List[ScoreResult]:
        """Score one micro-batch: pad to its bucket, one device round trip.
        A batch larger than max_batch splits. `fe_only=True` is the
        circuit-open tier."""
        if not requests:
            return []
        if len(requests) > self.max_batch:
            out: List[ScoreResult] = []
            for lo in range(0, len(requests), self.max_batch):
                out.extend(self.score_batch(requests[lo: lo + self.max_batch], fe_only=fe_only))
            return out
        n = len(requests)
        bucket = self.bucket_for(n)
        with self._lock:
            st = self._state
            st.active += 1
        try:
            with stage_scope(self.stages):
                packed = self._pack(requests, bucket, st, inject=not fe_only, fe_only=fe_only)
                scores, means = self._dispatch(packed, st, inject=not fe_only)
        finally:
            with self._lock:
                st.active -= 1
                self._lock.notify_all()
        flags = packed["cold_flags"]
        lflags = packed["lost_flags"]
        results = [ScoreResult(score=float(scores[i]), mean=float(means[i]), uid=requests[i].uid,
                               cold_start=bool(flags[i].any()), n_cold=int(flags[i].sum()),
                               fe_only=fe_only, n_lost=int(lflags[i].sum()))
                   for i in range(n)]
        now = time.monotonic()
        with self._lock:
            self._requests += n
            self._batches += 1
            if fe_only:
                # FE-only answers are cold by construction; they stay out of
                # the lookup counts, so cold_start_fraction keeps its meaning.
                self._fe_only_requests += n
            else:
                self._lookups += int(flags.size)
                self._cold_lookups += int(flags.sum())
            self._slots_total += bucket
            self._slots_padded += bucket - n
            if self._t_first is None:
                self._t_first = now
            self._t_last = now
        if self.health.state is ServingState.STARTING:
            self.health.mark_ready()
        return results

    def score_batch_fe_only(self, requests: Sequence[ScoreRequest]) -> List[ScoreResult]:
        """The circuit-open tier: fixed effects (+ offset) only, every
        random-effect row at the pinned zero row; no fault site fires."""
        return self.score_batch(requests, fe_only=True)

    # ------------------------------------------------------------ internals

    def _pack(self, requests: Sequence[ScoreRequest], bucket: int, state: _EngineState, *,
              inject: bool = True, fe_only: bool = False) -> dict:
        """Host-side batch assembly: a dense buffer per shard, each random
        effect's rows (padding slots at the pinned zero row), the offsets."""
        n = len(requests)
        with stage_timer("serve_pack"):
            buffers = {s: np.zeros((bucket, d), np.float32) for s, d in state.shard_dims.items()}
            offsets = np.zeros(bucket, np.float32)
            for i, r in enumerate(requests):
                offsets[i] = r.offset
                for s, payload in r.features.items():
                    buf = buffers.get(s)
                    if buf is None:
                        continue
                    if isinstance(payload, tuple):
                        idx, vals = payload
                        np.add.at(buf[i], np.asarray(idx, np.int64), vals)
                    else:
                        buf[i, :] = payload
        with stage_timer("serve_lookup"):
            if inject and self.inject_faults:
                faults.fault_point("lookup")
            re_coords = [c for c in state.coords if c.is_random_effect]
            cold_flags = np.zeros((n, len(re_coords)), bool)
            lost_flags = np.zeros((n, len(re_coords)), bool)
            rows_by_cid: Dict[str, np.ndarray] = {}
            # Two-tier coordinates: (override values, flags), the logical
            # rows and the store epoch the slots were resolved at.
            overrides_by_cid: Dict[str, tuple] = {}
            tiered: Dict[str, tuple] = {}
            for k, c in enumerate(re_coords):
                store = c.store
                padded = np.full(bucket, c.unseen_row if store is None else store.zero_slot, np.int64)
                rows_by_cid[c.cid] = padded
                if store is not None:
                    overrides_by_cid[c.cid] = (np.zeros((bucket, c.dim), np.float32),
                                               np.zeros(bucket, bool))
                if fe_only:
                    continue  # every slot at the pinned zero row: +0.0 exactly
                rows, _ = c.lookup_rows([r.entity_ids.get(c.random_effect_type) for r in requests])
                sh = c.shard_health
                if sh is not None:
                    sh.record_loads(rows, c.unseen_row)  # what a reshard plan reads
                if sh is not None and sh.any_lost:
                    # Rows of a LOST shard answer from the pinned zero row;
                    # cold starts already there are not counted as losses.
                    lost = sh.lost_mask(rows) & (rows != c.unseen_row)
                    if lost.any():
                        lost_flags[:, k] = lost
                        rows = np.where(lost, c.unseen_row, rows).astype(np.int32)
                        n_lost = int(lost.sum())
                        faults.COUNTERS.increment("shard_loss_fallbacks", n_lost)
                        with self._lock:
                            self._shard_loss_fallbacks += n_lost
                cold_flags[:, k] = rows == c.unseen_row
                if store is not None:
                    slots, ovr, flags, epoch = store.lookup(rows, bucket)
                    rows_by_cid[c.cid] = slots
                    overrides_by_cid[c.cid] = (ovr, flags)
                    tiered[c.cid] = (rows, epoch)
                else:
                    padded[:n] = rows
        return {"bucket": bucket, "buffers": buffers, "offsets": offsets, "rows_by_cid": rows_by_cid,
                "overrides_by_cid": overrides_by_cid, "tiered": tiered,
                "cold_flags": cold_flags, "lost_flags": lost_flags}

    def _dispatch(self, packed: dict, state: _EngineState, *, inject: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Upload, run the bucket program, fetch both outputs, under the
        watchdog on live traffic."""
        with stage_timer("serve_score"):
            if inject and self.inject_faults:
                faults.fault_point("score")
            wd_ms = self._watchdog_ms if inject else 0.0
            with self._watchdog.guard(wd_ms, f"serving dispatch (bucket {packed['bucket']})"):
                out = self._dispatch_device(packed, state)
            if wd_ms > 0 and self._hang_seen:
                # A guarded dispatch finished inside its deadline: the device
                # answers again (an unguarded FE-only dispatch proves nothing).
                self._hang_seen = False
                self.health.clear_degraded("device_hang")
        return out

    def _dispatch_device(self, packed: dict, state: _EngineState) -> Tuple[np.ndarray, np.ndarray]:
        with self._device_mutex:
            # Promotions write a two-tier plane in place under this mutex: a
            # batch resolved at an older epoch resolves its slots again.
            for c in state.coords:
                got = packed["tiered"].get(c.cid)
                if got is not None and got[1] != c.store.epoch:
                    slots, ovr, flags, _ = c.store.lookup(got[0], packed["bucket"], touch=False)
                    packed["rows_by_cid"][c.cid] = slots
                    packed["overrides_by_cid"][c.cid] = (ovr, flags)
            program = state.programs.get(packed["bucket"])
            if program is None:
                program = _BucketProgram(state, packed["bucket"], self.task, self.device)
                state.programs[packed["bucket"]] = program
                with self._lock:
                    self._compiles += 1
            return program.run(packed, self._stream)

    # -------------------------------------------------------------- metrics

    def warmup_buffer_bytes(self, state: Optional[_EngineState] = None) -> int:
        """Device bytes of one generation's static bucket buffers (every
        bucket's inputs and output), which a swap's pre-warm allocates
        beside the two resident generations."""
        st = state if state is not None else self._state
        n_re = sum(1 for c in st.coords if c.is_random_effect)
        width = sum(st.shard_dims.values())
        ovr = sum(c.dim * 4 + 1 for c in st.coords if c.store is not None)
        return sum(4 * b + 4 * b * width + 8 * b * n_re + 8 * b + b * ovr for b in self.buckets)

    def _sharding_metrics(self, state: _EngineState) -> Dict[str, object]:
        """The reference's sharding block for a single-tier bundle on one
        device (contracts.SERVING_SHARDING_KEYS order): row blocks count as
        its shards, and nothing moves between devices."""
        from photon_ml_tpu_torch.contracts import SERVING_SHARDING_KEYS

        health = [c.shard_health for c in state.coords if c.shard_health is not None]
        stores = [c.store for c in state.coords if c.store is not None]
        axis = max((h.n_shards for h in health), default=1)
        rows_per_shard = max([h.rows_per_shard for h in health] + [s.capacity + 1 for s in stores],
                             default=0)
        hot_fraction = min([1.0] + [s.hot_fraction for s in stores])
        shards_lost = sum(len(h.lost) for h in health)
        with self._lock:
            fallbacks = self._shard_loss_fallbacks
        return dict(zip(SERVING_SHARDING_KEYS, (False, axis, rows_per_shard, round(hot_fraction, 6),
                                                0, shards_lost, fallbacks)))

    @property
    def compiles(self) -> int:
        """Bucket programs this engine built (CUDA graphs captured on the
        card), over every generation it served."""
        with self._lock:
            return self._compiles

    @property
    def recompiles_after_warmup(self) -> Optional[int]:
        """Programs built since warmup(), or None before it ran."""
        with self._lock:
            base = self._warmup_compiles
            return None if base is None else max(0, self._compiles - base)

    def metrics(self) -> Dict[str, object]:
        """Engine-side counters; MicroBatcher.metrics() adds latency."""
        manager = self._bundle_manager
        with self._lock:
            st = self._state
            lookups = self._lookups
            cold = self._cold_lookups
            slots = self._slots_total
            padded = self._slots_padded
            elapsed = (self._t_last - self._t_first
                       if self._t_first is not None and self._t_last > self._t_first else 0.0)
            out = {
                "requests": self._requests,
                "batches": self._batches,
                "cold_start_lookups": cold,
                "cold_start_fraction": (cold / lookups) if lookups else 0.0,
                "padding_waste": (padded / slots) if slots else 0.0,
                "compiles": self._compiles,
                "recompiles_after_warmup": (None if self._warmup_compiles is None
                                            else max(0, self._compiles - self._warmup_compiles)),
                "fe_only_requests": self._fe_only_requests,
                "bundle_version": st.version,
                "upload_bytes": st.bundle.upload_bytes,
                "upload_s": st.bundle.upload_s,
                "engine_qps": (self._requests / elapsed) if elapsed > 0 else None,
            }
        out["sharding"] = self._sharding_metrics(st)
        # The two-tier stores' counters (0 on a single-tier bundle).
        tier = dict.fromkeys(("hot_tier_hits", "cold_tier_hits", "promotions", "evictions",
                              "promote_failures", "pending_promotions"), 0)
        for c in st.coords:
            if c.store is not None:
                sm = c.store.metrics()
                for key in tier:
                    tier[key] += int(sm[key])
        out.update(tier)
        health = self.health.snapshot()
        out["state"] = health["state"]
        out["degraded_reasons"] = health["degraded_reasons"]
        out.update(self.breaker.snapshot())
        out["bundle_swaps"] = manager.swaps if manager is not None else 0
        out["bundle_swap_rollbacks"] = manager.rollbacks if manager is not None else 0
        out["bundle_deltas"] = manager.deltas if manager is not None else 0
        orch = self._reshard_orchestrator
        out["bundle_reshards"] = orch.reshards if orch is not None else 0
        out["bundle_rebalances"] = orch.rebalances if orch is not None else 0
        out["bundle_reshard_rollbacks"] = orch.rollbacks if orch is not None else 0
        out["stage_walls_s"] = dict(sorted(self.stages.seconds.items()))
        return out
