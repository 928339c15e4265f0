"""Serving bundles: a GAME model staged into device memory once.

Port of `photon_ml_tpu/serving/bundle.py`, single device. A
`ServingBundle` is the state an online engine keeps pinned across
requests:

  * per fixed-effect coordinate: the weight vector, one tensor;
  * per random-effect coordinate: the dense `(n_entities + 1, dim)`
    coefficient matrix, whose last row is the pinned zero row (an unknown
    entity scores with the fixed effects only: GLMix's cold start), and a
    host-side entity-id -> row index;
  * optionally the feature index maps, so a request may name its features
    as (name, term) keys.

`load_bundle` / `from_artifact` stage a saved model directory (either
package's `cli.train` writes one; original feature space), `from_model`
an in-memory (model, specs) pair. A projected random effect is refused:
serving scores in the original space. Every plane is a private copy on the
bundle's device, so `restage_shard` may write rows in place (the engine's
captured programs read the planes at fixed addresses; call it through
`ServingEngine.restage_shard`, which holds the device mutex).

`row_blocks=S` (the port's own keyword) cuts each random-effect matrix
into S row blocks on the one device, the reference's row-sharded layout
without its devices: `rows_per_shard = ceil((E + 1) / S)`, the matrix
zero-padded to S blocks, `unseen_row` still the logical pinned zero row.
Each block is a shard of `ShardHealth`, which a multi-host serving worker
marks lost where another host owns it (cli/serve_multihost.py).

`hot_rows=` (or PHOTON_SERVING_HOT_ROWS) stages a random effect in the
two-tier store (`TwoTierEntityStore`): a `(capacity + 1, dim)` hot plane on
the device, the full matrix in host RAM, rows promoted into the plane on
a `photon-serving-promote` thread. Unlike the reference, which builds a
new device matrix for every promotion, the port writes promotions into
the plane in place (a captured graph reads one address), under the device
mutex, and counts each write in the store's `epoch`, against which a batch
re-resolves its slots before it replays (serving/engine.py).
`demote_bundle_to_host_tier` / `promote_bundle_from_host_tier` move a whole
bundle's random effects to the host tier and back, bit-equal (the
multi-tenant registry's pressure valve, serving/tenancy.py).

Not ported: the row-sharded store over devices (`mesh=`,
`PHOTON_SERVING_ENTITY_SHARD`, a matrix already row-sharded: ROADMAP item
9c) and the precision ladder's quantized planes (item 10f); each raises
where it is asked for.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, feature_key
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
from photon_ml_tpu_torch.io.model_store import GameModelArtifact
from photon_ml_tpu_torch.transformers.game_transformer import CoordinateScoringSpec
from photon_ml_tpu_torch.types import TaskType
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

Tensor = torch.Tensor

# Request features for one shard: a dense (dim,) row, or (indices, values).
ShardFeatures = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]

_SHARDED_STORE = "the row-sharded serving store is ROADMAP item 9c (not ported)"
_PRECISION_LADDER = "the precision ladder is ROADMAP item 10f (not ported)"


@dataclasses.dataclass
class ScoreRequest:
    """One scoring request: per-shard features and per-RE-type entity ids.

    `features[shard]` is a dense (dim,) row or an (indices, values) pair
    (duplicate indices add up). A shard absent from the mapping scores as an
    all-zero row; an entity id missing for a random-effect type is a cold
    start. `deadline_ms` is the latency budget from submission to the
    micro-batcher (None: the batcher's default)."""

    features: Dict[str, ShardFeatures] = dataclasses.field(default_factory=dict)
    entity_ids: Dict[str, object] = dataclasses.field(default_factory=dict)
    offset: float = 0.0
    uid: Optional[str] = None
    deadline_ms: Optional[float] = None


def default_provenance(origin: str = "full_fit") -> Dict[str, object]:
    """A new bundle's lineage block (contracts.BUNDLE_PROVENANCE_KEYS)."""
    return {"origin": origin, "generation": 0, "deltas_applied": 0,
            "last_delta_source": None, "last_delta_ts": None}


def _stage_shard(label: str, fn):
    """One staging step under the `shard_upload` fault site, retried
    PHOTON_SHARD_UPLOAD_RETRIES times (counted in shard_upload_retries).
    Exhausted retries propagate: a bundle build fails (a hot-swap rolls
    back), a restage leaves its shard lost."""

    def attempt():
        faults.fault_point("shard_upload")
        return fn()

    return faults.retry(attempt, faults.bounded_policy(int(get_knob("PHOTON_SHARD_UPLOAD_RETRIES"))),
                        label=f"shard staging {label}", counter="shard_upload_retries")


def _upload(t: Tensor, device: torch.device) -> Tensor:
    """A private float32 copy of `t` on `device`."""
    out = torch.empty(tuple(t.shape), dtype=torch.float32, device=device)
    out.copy_(t)
    return out


class ShardHealth:
    """Per-shard health of one random-effect coordinate's resident rows: the
    whole matrix as one shard, or its row blocks (`row_blocks=`). A LOST
    shard's entities answer from the pinned zero row (FE-only) until it is
    restaged. `loads` counts each shard's looked-up rows (cold starts
    excluded), the load a reshard plan and the autopilot read."""

    def __init__(self, n_shards: int, rows_per_shard: int):
        self.n_shards = int(n_shards)
        self.rows_per_shard = int(rows_per_shard)
        self._lock = threading.Lock()
        self._lost: set = set()
        self._loads = [0] * self.n_shards

    def _check(self, idx: int) -> int:
        idx = int(idx)
        if not 0 <= idx < self.n_shards:
            raise ValueError(f"shard index {idx} out of range (n_shards={self.n_shards})")
        return idx

    def row_range(self, idx: int) -> Tuple[int, int]:
        lo = self._check(idx) * self.rows_per_shard
        return lo, lo + self.rows_per_shard

    def mark_lost(self, idx: int) -> None:
        with self._lock:
            self._lost.add(self._check(idx))

    def mark_ok(self, idx: int) -> None:
        with self._lock:
            self._lost.discard(self._check(idx))

    @property
    def lost(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._lost))

    @property
    def any_lost(self) -> bool:
        with self._lock:
            return bool(self._lost)

    @property
    def loads(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(self._loads)

    def record_loads(self, rows: np.ndarray, unseen_row: int) -> None:
        """Count one lookup's rows into their shards' loads (rows at the
        pinned zero row are cold starts, not load)."""
        rows = np.asarray(rows, np.int64)
        rows = rows[rows != int(unseen_row)]
        if not len(rows):
            return
        counts = np.bincount(np.clip(rows // self.rows_per_shard, 0, self.n_shards - 1),
                             minlength=self.n_shards)
        with self._lock:
            for i in range(self.n_shards):
                self._loads[i] += int(counts[i])

    def lost_mask(self, rows: np.ndarray) -> np.ndarray:
        """Which of `rows` live in a LOST shard."""
        with self._lock:
            lost = tuple(self._lost)
        shard_of = np.asarray(rows, np.int64) // self.rows_per_shard
        mask = np.zeros(len(rows), bool)
        for idx in lost:
            mask |= shard_of == idx
        return mask


class TwoTierEntityStore:
    """Two-tier random-effect rows: a hot set on the device and the cold
    tier in host RAM, with promotion in the background.

    The hot plane is `(capacity + 1, dim)` on `device`; slot `capacity` is
    the pinned zero row (unknown entities and padding gather it). The cold
    tier is the full `(E + 1, dim)` float32 matrix in host RAM. `lookup`
    resolves each logical row to its hot slot or, on a miss, copies the
    row out of the cold tier into the batch's override buffer (so the
    answer is the single-tier answer bit for bit) and queues the row for
    promotion, which evicts the least recently used slot. A row past the
    last entity falls through to the pinned zero slot.

    Promotions write into the plane in place (a captured graph reads one
    address) on the short-lived `photon-serving-promote` thread, holding
    the device mutex (`bind_device_mutex`: the engine's) and then the
    store lock, and bump `epoch` with every write; a batch that resolved
    its slots at an older epoch resolves them again under the device mutex
    before it replays. `drain()` waits for queued promotions, `close()`
    stops and joins the thread.

    The hot set starts with the first `capacity` rows, or with
    `preload_rows` (the hot-row rebalance's measured rows, serving/
    reshard.py: deduplicated, the pinned row excluded, cut to capacity).
    `promotion_stats()` counts each row's promotions, the hotness a
    rebalance plan reads."""

    def __init__(self, cold_matrix: np.ndarray, hot_rows: int, device: DeviceLike = "cpu",
                 preload_rows: Optional[Sequence[int]] = None):
        self._cold = np.ascontiguousarray(cold_matrix, dtype=np.float32)
        self.n_rows = int(self._cold.shape[0])  # logical E + 1
        self.dim = int(self._cold.shape[1])
        cap = max(0, min(int(hot_rows), self.n_rows - 1))
        self.capacity = cap
        self.zero_slot = cap
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._device_mutex: threading.Lock = threading.Lock()
        if preload_rows is None:
            preload = list(range(cap))  # the first rows, as the reference preloads
        else:
            seen: set = set()
            preload = []
            for r in preload_rows:
                r = int(r)
                if 0 <= r < self.n_rows - 1 and r not in seen:
                    seen.add(r)
                    preload.append(r)
                if len(preload) >= cap:
                    break
        self.preloaded_rows: Tuple[int, ...] = tuple(preload)
        hot = np.zeros((cap + 1, self.dim), np.float32)
        if preload:
            hot[: len(preload)] = self._cold[preload]
        self.hot = _upload(torch.from_numpy(hot), self.device)
        self._slot_of_row: Dict[int, int] = {r: s for s, r in enumerate(preload)}
        self._row_of_slot: List[Optional[int]] = list(preload) + [None] * (cap - len(preload))
        self._tick = 0
        self._last_used = [0] * cap
        self._pending: Dict[int, bool] = {}
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.epoch = 0
        self.hot_hits = 0
        self.cold_hits = 0
        self.promotions = 0
        self.evictions = 0
        self.promote_failures = 0
        self._promote_count: Dict[int, int] = {}  # row -> its promotions

    def bind_device_mutex(self, mutex: threading.Lock) -> None:
        """The mutex that serializes this device's dispatches (the serving
        engine's): promotions write the plane under it."""
        self._device_mutex = mutex

    @property
    def cold_matrix(self) -> np.ndarray:
        """The full host-RAM coefficient matrix."""
        return self._cold

    def promotion_stats(self) -> Dict[int, int]:
        """Promotions a logical row (the hot-row rebalance plan's input)."""
        with self._lock:
            return dict(self._promote_count)

    @property
    def hot_nbytes(self) -> int:
        """Device bytes of the hot plane (what a device-memory budget
        charges; the cold tier is host RAM)."""
        return (self.capacity + 1) * self.dim * 4

    @property
    def hot_fraction(self) -> float:
        return self.capacity / max(1, self.n_rows - 1)

    def lookup(self, rows: np.ndarray, bucket: int, *, touch: bool = True
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
        """Logical rows -> (hot slots, override rows, override flags, the
        epoch they hold at), padded to `bucket`. A cold hit carries its row
        in the override buffer and is queued for promotion. `touch=False`
        (a batch resolving again after a promotion) only reads: no hit
        counted, no recency moved, no promotion queued."""
        n = len(rows)
        slots = np.full(bucket, self.zero_slot, np.int64)
        ovr = np.zeros((bucket, self.dim), np.float32)
        flags = np.zeros(bucket, bool)
        with self._lock:
            self._tick += touch
            tick = self._tick
            for i in range(n):
                r = int(rows[i])
                if r >= self.n_rows - 1:
                    continue  # unseen: the pinned zero slot
                s = self._slot_of_row.get(r)
                if s is not None:
                    slots[i] = s
                    if touch:
                        self._last_used[s] = tick
                        self.hot_hits += 1
                else:
                    ovr[i] = self._cold[r]
                    flags[i] = True
                    if touch:
                        self.cold_hits += 1
                        if self.capacity and not self._closed:
                            self._pending.setdefault(r, True)
            epoch = self.epoch
            if touch and self._pending and not self._closed:
                self._maybe_start_worker_locked()
        return slots, ovr, flags, epoch

    def _maybe_start_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._span_h = telemetry.span_handoff()
            self._worker = threading.Thread(target=self._promote_pending,
                                            name="photon-serving-promote", daemon=True)
            self._worker.start()

    def _promote_pending(self) -> None:
        with telemetry.adopt_span(getattr(self, "_span_h", None)):
            while self._promote_round():
                pass

    def _promote_round(self) -> bool:
        """One batch of queued promotions, written in place under the device
        mutex; False when nothing is left (or the store closed)."""
        with self._device_mutex, self._lock:
            if self._closed or not self._pending:
                return False
            batch = list(self._pending)[: max(1, self.capacity)]
            idx: List[int] = []
            srcs: List[int] = []
            for r in batch:
                self._pending.pop(r, None)
                if r in self._slot_of_row:
                    continue
                s = int(np.argmin(self._last_used))
                old = self._row_of_slot[s]
                if old is not None:
                    del self._slot_of_row[old]
                    self.evictions += 1
                self._row_of_slot[s] = r
                self._slot_of_row[r] = s
                self._last_used[s] = self._tick
                self.promotions += 1
                self._promote_count[r] = self._promote_count.get(r, 0) + 1
                idx.append(s)
                srcs.append(r)
            if not idx:
                return True
            # Any write (and any eviction) moves the epoch: a batch resolved
            # before it resolves again before it replays.
            self.epoch += 1
            # The reference's LRU choice can give one slot to several rows of
            # a round (every slot last used at the same tick): the slot holds
            # the last of them, the one the index maps it to, so only that
            # write is made (a scatter with repeated indices has no defined
            # winner).
            last = {s: r for s, r in zip(idx, srcs)}
            try:
                faults.fault_point("promote")
                with telemetry.span("promote_rows", rows=len(last)):
                    self.hot[torch.as_tensor(list(last), device=self.device)] = torch.from_numpy(
                        self._cold[list(last.values())]).to(self.device)
                    if self.hot.is_cuda:
                        torch.cuda.synchronize(self.device)
            except BaseException as exc:
                # Roll the index back: these rows keep resolving through the
                # cold tier, never to a slot that was not written.
                for s, r in zip(idx, srcs):
                    self._slot_of_row.pop(r, None)
                    self._row_of_slot[s] = None
                    self.promotions -= 1
                    n_p = self._promote_count.get(r, 0) - 1
                    if n_p > 0:
                        self._promote_count[r] = n_p
                    else:
                        self._promote_count.pop(r, None)
                self.promote_failures += len(idx)
                faults.COUNTERS.increment("promote_failures", len(idx))
                if faults.is_device_error(exc):
                    logger.warning("promotion of %d row(s) failed (%s); rows stay cold", len(idx), exc)
                    return True
                self._closed = True
                return False
            return True

    def drain(self, timeout_s: float = 30.0) -> None:
        """Block until every queued promotion is written."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                busy = bool(self._pending) and not self._closed
                if busy:
                    self._maybe_start_worker_locked()
                w = self._worker
            if w is not None and w.is_alive():
                w.join(timeout=0.2)
            elif not busy:
                return

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._pending.clear()
            w = self._worker
        if w is not None and w is not threading.current_thread():
            w.join(timeout=10)

    def metrics(self) -> Dict[str, object]:
        with self._lock:
            return {"hot_rows": self.capacity, "hot_fraction": round(self.hot_fraction, 6),
                    "hot_tier_hits": self.hot_hits, "cold_tier_hits": self.cold_hits,
                    "promotions": self.promotions, "evictions": self.evictions,
                    "promote_failures": self.promote_failures,
                    "pending_promotions": len(self._pending)}


@dataclasses.dataclass
class ServingCoordinate:
    """One coordinate's device-resident serving state."""

    cid: str
    shard: str
    params: Tensor  # (dim,) fixed-effect weights or (E + 1, dim) RE matrix
    norm: Optional[object] = None
    random_effect_type: Optional[str] = None
    entity_index: Optional[Mapping[object, int]] = None
    shard_health: Optional[ShardHealth] = None
    # E + 1 where the matrix is padded past it to whole row blocks.
    logical_rows: Optional[int] = None
    # S where the bundle was staged with `row_blocks=S` (its placement
    # changes only with a restage; serving/delta.py refuses to move rows).
    row_blocks: Optional[int] = None
    # The two-tier store: `params` is then its hot plane.
    store: Optional[TwoTierEntityStore] = None

    @property
    def is_random_effect(self) -> bool:
        return self.random_effect_type is not None

    @property
    def dim(self) -> int:
        return int(self.params.shape[-1])

    @property
    def unseen_row(self) -> int:
        """The pinned zero row unknown entities gather (the logical last
        row: padding rows past it are never gathered)."""
        rows = self.logical_rows if self.logical_rows is not None else int(self.params.shape[0])
        return rows - 1

    def device_nbytes(self) -> int:
        """Device bytes of this coordinate (a two-tier store's hot plane:
        its cold tier is host RAM)."""
        if self.store is not None:
            return self.store.hot_nbytes
        return int(self.params.numel()) * self.params.element_size()

    def lookup_rows(self, entity_ids: Sequence[object]) -> Tuple[np.ndarray, int]:
        """Entity ids -> coefficient rows (None or unknown -> the pinned
        zero row), and the count of cold starts. A non-string id is looked
        up by its string form when the index keys are strings, as offline
        scoring does."""
        index = self.entity_index or {}
        unseen = self.unseen_row
        coerce = bool(index) and isinstance(next(iter(index)), str)
        rows = np.empty(len(entity_ids), np.int32)
        cold = 0
        for i, eid in enumerate(entity_ids):
            if eid is None:
                rows[i] = unseen
                cold += 1
                continue
            if coerce and not isinstance(eid, str):
                eid = str(eid)
            row = index.get(eid, unseen)
            rows[i] = row
            cold += row == unseen
        return rows, cold


@dataclasses.dataclass
class ServingBundle:
    """A device-pinned GAME model and the host indexes serving needs."""

    task: TaskType
    coordinates: Dict[str, ServingCoordinate]
    device: torch.device
    index_maps: Optional[Mapping[str, IndexMap]] = None
    # Bytes staged onto the device and the seconds it took, once at load.
    upload_bytes: int = 0
    upload_s: float = 0.0
    released: bool = False
    provenance: Dict[str, object] = dataclasses.field(default_factory=default_provenance)

    @property
    def coordinate_ids(self) -> List[str]:
        return list(self.coordinates.keys())

    def release(self, close_stores: bool = True) -> None:
        """Drop this bundle's device state (a retired hot-swap generation);
        the memory is freed when the last reference goes. Two-tier stores
        stop their promotion thread, unless `close_stores=False` (stores
        carried into a successor bundle, which owns them now). Idempotent."""
        if close_stores:
            for c in self.coordinates.values():
                if c.store is not None:
                    c.store.close()
        self.coordinates = {}
        self.index_maps = None
        self.released = True

    def device_bytes(self) -> int:
        """Device-resident model bytes (two-tier coordinates: the hot plane)."""
        return sum(c.device_nbytes() for c in self.coordinates.values())

    def stores(self) -> List[TwoTierEntityStore]:
        return [c.store for c in self.coordinates.values() if c.store is not None]

    def mark_shard_lost(self, cid: str, shard_index: int) -> Tuple[int, int]:
        """Mark one coefficient shard LOST: requests whose entity row falls
        in the returned [lo, hi) range answer from the pinned zero row until
        `restage_shard` recovers it."""
        c = self.coordinates[cid]
        if c.shard_health is None:
            raise ValueError(f"coordinate {cid!r} has no device-resident shard tracking "
                             "(a fixed-effect or two-tier coordinate)")
        c.shard_health.mark_lost(shard_index)
        logger.warning("serving shard lost: %s shard %d (rows %s); its entities answer from the "
                       "pinned zero row until restaged", cid, shard_index,
                       c.shard_health.row_range(shard_index))
        return c.shard_health.row_range(shard_index)

    def restage_shard(self, cid: str, shard_index: int, rows: Optional[np.ndarray] = None) -> int:
        """Recover one lost shard: write its rows IN PLACE (the engine's
        captured programs keep reading the same addresses) under the
        `shard_upload` fault site with bounded retry. `rows` is the host
        source of the block; None re-reads the resident block. Returns the
        bytes restaged; a final failure leaves the shard lost and
        re-raises."""
        c = self.coordinates[cid]
        if c.shard_health is None:
            raise ValueError(f"coordinate {cid!r} has no device-resident shard tracking")
        lo, hi = c.shard_health.row_range(shard_index)
        if rows is None:
            rows = c.params[lo:hi].cpu().numpy()
        rows = np.ascontiguousarray(rows, np.float32)
        if rows.shape != (hi - lo, c.dim):
            raise ValueError(f"restage rows shape {rows.shape} != shard shape {(hi - lo, c.dim)}")

        def upload():
            c.params[lo:hi].copy_(torch.from_numpy(rows))
            if c.params.is_cuda:
                torch.cuda.synchronize(c.params.device)

        _stage_shard(f"{cid} shard {shard_index} restage", upload)
        c.shard_health.mark_ok(shard_index)
        logger.info("serving shard restaged: %s shard %d (%d bytes)", cid, shard_index, rows.nbytes)
        return int(rows.nbytes)

    def shard_dims(self) -> Dict[str, int]:
        """Feature width per shard that any coordinate reads."""
        return {c.shard: c.dim for c in self.coordinates.values()}

    def encode_request(self, features: Mapping[str, Union[ShardFeatures, Mapping[str, float]]], *,
                       entity_ids: Optional[Mapping[str, object]] = None, offset: float = 0.0,
                       uid: Optional[str] = None) -> ScoreRequest:
        """A ScoreRequest, with {feature_key: value} mappings resolved
        through the bundle's index maps (features the map does not know are
        dropped, as offline ingest drops them)."""
        enc: Dict[str, ShardFeatures] = {}
        for shard, payload in features.items():
            if isinstance(payload, Mapping):
                if self.index_maps is None or shard not in self.index_maps:
                    raise ValueError(f"no index map for shard {shard!r}: named-feature requests "
                                     "need a bundle loaded with index maps")
                imap = self.index_maps[shard]
                idx: List[int] = []
                vals: List[float] = []
                for key, v in payload.items():
                    j = imap.get_index(key)
                    if j >= 0:
                        idx.append(j)
                        vals.append(float(v))
                enc[shard] = (np.asarray(idx, np.int32), np.asarray(vals, np.float32))
            else:
                enc[shard] = payload
        return ScoreRequest(features=enc, entity_ids=dict(entity_ids or {}), offset=float(offset),
                            uid=uid)

    @classmethod
    def from_model(cls, model: GameModel, specs: Mapping[str, CoordinateScoringSpec],
                   task: TaskType, *, device: DeviceLike = "cuda",
                   index_maps: Optional[Mapping[str, IndexMap]] = None, mesh=None,
                   hot_rows: Optional[Union[int, Mapping[str, int]]] = None,
                   origin: str = "full_fit", row_blocks: Optional[int] = None) -> "ServingBundle":
        """Stage an in-memory (model, specs) pair onto `device`. A projected
        random effect is refused (serving scores in the original space:
        export through `model_bridge.artifact_from_game_model`, which
        back-projects, then `from_artifact`). `row_blocks=S` stages each
        random-effect matrix as S row blocks (the module docstring);
        `hot_rows` (an int, or {cid: int}) stages random effects in the
        two-tier store with that many hot rows."""
        if mesh is not None:
            raise NotImplementedError(f"mesh=: {_SHARDED_STORE}")
        if hot_rows is not None and row_blocks is not None:
            raise ValueError("hot_rows and row_blocks are exclusive: a two-tier store keeps the "
                             "matrix in host RAM, not in row blocks on the device")
        if row_blocks is not None and int(row_blocks) < 1:
            raise ValueError(f"row_blocks must be at least 1, got {row_blocks}")
        dev = resolve_device(device)
        t0 = time.perf_counter()
        coords: Dict[str, ServingCoordinate] = {}
        for cid in model.coordinate_ids:
            spec = specs[cid]
            m = model[cid]
            if isinstance(m, FixedEffectModel):
                params = _stage_shard(f"{cid} (fixed-effect plane)",
                                      lambda: _upload(m.coefficients.means, dev))
                coords[cid] = ServingCoordinate(cid, spec.shard, params, norm=spec.norm)
            elif isinstance(m, RandomEffectModel):
                if spec.projector is not None:
                    raise ValueError(
                        f"coordinate {cid!r} is trained in projected space; serving bundles score "
                        "in original space: export the artifact "
                        "(model_bridge.artifact_from_game_model) and build the bundle from it")
                matrix = m.coefficients_matrix
                if type(matrix).__name__ == "DTensor" or \
                        matrix.shape[0] != len(spec.entity_index or {}) + 1:
                    raise NotImplementedError(
                        f"coordinate {cid!r}: the matrix holds {matrix.shape[0]} rows for "
                        f"{len(spec.entity_index or {})} entities (a rank's row shard); "
                        f"{_SHARDED_STORE}")
                logical = int(matrix.shape[0])
                hr = hot_rows.get(cid) if isinstance(hot_rows, Mapping) else hot_rows
                if hr is not None:
                    from photon_ml_tpu_torch.ops.normalization import PerEntityNormalization

                    if isinstance(spec.norm, PerEntityNormalization):
                        raise ValueError(f"coordinate {cid!r}: per-entity normalization tables "
                                         "are entity-sized and not tiered; stage single-tier")
                    host = matrix.detach().float().cpu().numpy()
                    store = _stage_shard(f"{cid} (two-tier hot set)",
                                         lambda: TwoTierEntityStore(host, int(hr), dev))
                    coords[cid] = ServingCoordinate(
                        cid, spec.shard, store.hot, norm=spec.norm,
                        random_effect_type=spec.random_effect_type,
                        entity_index=dict(spec.entity_index or {}), logical_rows=logical,
                        store=store)
                    continue
                if row_blocks is None:
                    health = ShardHealth(1, logical)
                else:
                    # The reference's blocks (parallel/mesh.pad_rows_for_mesh):
                    # ceil(rows / S) rows each, zero rows past E + 1.
                    rows_per = -(-logical // int(row_blocks))
                    health = ShardHealth(int(row_blocks), rows_per)
                    pad = rows_per * int(row_blocks) - logical
                    if pad:
                        matrix = torch.cat([matrix.float(),
                                            matrix.new_zeros((pad, matrix.shape[1]), dtype=torch.float32)])
                params = _stage_shard(f"{cid} (replicated matrix)", lambda: _upload(matrix, dev))
                coords[cid] = ServingCoordinate(
                    cid, spec.shard, params, norm=spec.norm,
                    random_effect_type=spec.random_effect_type,
                    entity_index=dict(spec.entity_index or {}),
                    shard_health=health, logical_rows=logical, row_blocks=row_blocks)
            else:
                raise TypeError(f"unknown model type {type(m)} for {cid!r}")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return cls(task=task, coordinates=coords, device=dev, index_maps=index_maps,
                   upload_bytes=sum(c.device_nbytes() for c in coords.values()),
                   upload_s=time.perf_counter() - t0, provenance=default_provenance(origin))

    @classmethod
    def from_artifact(cls, artifact: GameModelArtifact, *, device: DeviceLike = "cuda",
                      index_maps: Optional[Mapping[str, IndexMap]] = None, mesh=None,
                      hot_rows: Optional[Union[int, Mapping[str, int]]] = None,
                      row_blocks: Optional[int] = None) -> "ServingBundle":
        """The production path: a persisted artifact (original feature
        space, string entity ids) -> a bundle on `device`. The model is
        built on the host and staged once."""
        from photon_ml_tpu_torch.io.model_bridge import game_model_from_artifact

        model, specs = game_model_from_artifact(artifact, "cpu")
        return cls.from_model(model, specs, artifact.task, device=device, index_maps=index_maps,
                              mesh=mesh, hot_rows=hot_rows, origin="artifact",
                              row_blocks=row_blocks)


def serving_hot_rows() -> Optional[int]:
    """The two-tier hot-set size PHOTON_SERVING_HOT_ROWS asks for, or None."""
    rows = int(get_knob("PHOTON_SERVING_HOT_ROWS"))
    return rows if rows > 0 else None


def demote_bundle_to_host_tier(bundle: ServingBundle, hot_rows: int = 0) -> ServingBundle:
    """`bundle` with every single-tier random effect moved to a
    TwoTierEntityStore (`hot_rows` rows on the device; 0: none, every
    lookup rides the override buffers) and the full matrix in host RAM.
    Answers stay bit-equal: the override row is the matrix row. Fixed
    effects and stores already two-tier carry over by reference. A bundle
    staged in row blocks (a multi-host worker's placement) is refused."""
    coords: Dict[str, ServingCoordinate] = {}
    for cid, c in bundle.coordinates.items():
        if not c.is_random_effect or c.store is not None:
            coords[cid] = c
            continue
        if c.row_blocks is not None:
            raise ValueError(f"coordinate {cid!r} is staged in row blocks; demotion to the host "
                             "tier only applies to single-tier matrices")
        logical = c.unseen_row + 1
        host = c.params[:logical].detach().cpu().numpy()
        store = TwoTierEntityStore(host, int(hot_rows), bundle.device)
        coords[cid] = ServingCoordinate(cid, c.shard, store.hot, norm=c.norm,
                                        random_effect_type=c.random_effect_type,
                                        entity_index=c.entity_index, logical_rows=logical,
                                        store=store)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
    return ServingBundle(task=bundle.task, coordinates=coords, device=bundle.device,
                         index_maps=bundle.index_maps,
                         upload_bytes=sum(c.device_nbytes() for c in coords.values()),
                         provenance=dict(bundle.provenance))


def promote_bundle_from_host_tier(bundle: ServingBundle) -> ServingBundle:
    """The inverse of `demote_bundle_to_host_tier`: every two-tier
    coordinate as a single-tier matrix on the device, copied from its cold
    tier (the original float32 rows, so bit-equal). Other coordinates carry
    over by reference; the old bundle still owns its stores."""
    coords: Dict[str, ServingCoordinate] = {}
    for cid, c in bundle.coordinates.items():
        if c.store is None:
            coords[cid] = c
            continue
        full = _upload(torch.from_numpy(c.store.cold_matrix), bundle.device)
        logical = int(full.shape[0])
        coords[cid] = ServingCoordinate(cid, c.shard, full, norm=c.norm,
                                        random_effect_type=c.random_effect_type,
                                        entity_index=c.entity_index,
                                        shard_health=ShardHealth(1, logical), logical_rows=logical)
    if bundle.device.type == "cuda":
        torch.cuda.synchronize(bundle.device)
    return ServingBundle(task=bundle.task, coordinates=coords, device=bundle.device,
                         index_maps=bundle.index_maps,
                         upload_bytes=sum(c.device_nbytes() for c in coords.values()),
                         provenance=dict(bundle.provenance))


def quantize_bundle_rows(*args, **kwargs):
    """The precision ladder's quantized planes (not ported)."""
    raise NotImplementedError(f"quantize_bundle_rows: {_PRECISION_LADDER}")


def restore_bundle_precision(*args, **kwargs):
    """The precision ladder's restore (not ported)."""
    raise NotImplementedError(f"restore_bundle_precision: {_PRECISION_LADDER}")


def load_bundle(model_dir: str, *, device: DeviceLike = "cuda",
                index_maps: Optional[Mapping[str, IndexMap]] = None, mesh=None,
                hot_rows: Optional[Union[int, Mapping[str, int]]] = None,
                row_blocks: Optional[int] = None) -> ServingBundle:
    """Load a model directory (the training driver's layout) into a bundle
    on `device`. Index maps default to the JSON maps saved beside the model
    (`<model_dir>/feature-indexes/<shard>.json`), as in cli.score.
    `row_blocks` as in `from_model`; `hot_rows` defaults to
    PHOTON_SERVING_HOT_ROWS (`serving_hot_rows`). PHOTON_SERVING_ENTITY_SHARD
    selects a store the port has not got, and raises when set."""
    from photon_ml_tpu_torch.io import model_store

    if get_knob("PHOTON_SERVING_ENTITY_SHARD"):
        raise NotImplementedError(f"PHOTON_SERVING_ENTITY_SHARD is set: {_SHARDED_STORE}")
    if hot_rows is None and row_blocks is None:
        hot_rows = serving_hot_rows()
    if index_maps is None:
        index_dir = os.path.join(model_dir, "feature-indexes")
        index_maps = {os.path.splitext(os.path.basename(p))[0]: IndexMap.load(p)
                      for p in sorted(glob.glob(os.path.join(index_dir, "*.json")))}
        if not index_maps:
            raise FileNotFoundError(f"no feature index maps under {index_dir}; pass index_maps "
                                    "explicitly (e.g. resolved from an off-heap store)")
    artifact = model_store.load_game_model(model_dir, index_maps)
    return ServingBundle.from_artifact(artifact, device=device, index_maps=index_maps, mesh=mesh,
                                       hot_rows=hot_rows, row_blocks=row_blocks)


def request_from_record(bundle: ServingBundle, record: Mapping[str, object],
                        shard_configs: Mapping[str, object], *, uid_field: str = "uid",
                        offset_field: str = "offset") -> ScoreRequest:
    """A reference-shaped Avro record (name/term/value feature bags and id
    fields) -> ScoreRequest, built as offline ingest builds the row: the
    shard's bags, duplicate (name, term) entries added up, the intercept
    where the shard has one; an id tag is the record field, a "map.key"
    path, or the metadataMap entry, and a missing one the string ""."""
    features: Dict[str, Dict[str, float]] = {}
    for shard, cfg in shard_configs.items():
        fmap: Dict[str, float] = {}
        for bag in cfg.feature_bags:
            for ntv in record.get(bag) or ():
                key = feature_key(ntv.get("name", ""), ntv.get("term", "") or "")
                fmap[key] = fmap.get(key, 0.0) + float(ntv["value"])
        if getattr(cfg, "has_intercept", False):
            fmap[INTERCEPT_KEY] = fmap.get(INTERCEPT_KEY, 0.0) + 1.0
        features[shard] = fmap

    def _tag(tag: str) -> str:
        v = record.get(tag)
        field, _, map_key = tag.partition(".")
        if v is None and map_key:
            inner = record.get(field)
            if isinstance(inner, Mapping):
                v = inner.get(map_key)
        if v is None:
            meta = record.get("metadataMap")
            v = meta.get(tag, "") if isinstance(meta, Mapping) else ""
        return str(v)

    entity_ids = {c.random_effect_type: _tag(c.random_effect_type)
                  for c in bundle.coordinates.values() if c.is_random_effect}
    uid = record.get(uid_field)
    return bundle.encode_request(features, entity_ids=entity_ids,
                                 offset=float(record.get(offset_field) or 0.0),
                                 uid=None if uid is None else str(uid))
