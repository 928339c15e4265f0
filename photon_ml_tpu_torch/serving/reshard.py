"""Live placement changes of a READY serving engine on one card.

Port of the one-card half of `photon_ml_tpu/serving/reshard.py`: the
actuators the autopilot drives on one card.

* `plan_rebalance` / `MeshReshardOrchestrator.rebalance(cid)`: a two-tier
  coordinate's `TwoTierEntityStore` counts each row's promotions
  (`promotion_stats()`); the rows promoted at least
  PHOTON_REBALANCE_MIN_PROMOTIONS times, hottest first, cut to the hot
  set's capacity, become the preload of a NEW store over the same host
  rows. The new generation is staged beside the live one (the
  `reshard_stage` site, PHOTON_RESHARD_RETRIES bounded retries), its bucket
  programs pre-warmed (on the card: new CUDA graphs, the registry's
  co-batch hook included), and flipped through the port's one sequence,
  `BundleManager._stage_and_commit` (kind "rebalance": the `reshard_commit`
  site, `reshard_start` / `reshard_commit` journal lines, or
  `reshard_rollback` and `reshard_rollbacks` on a failure, with the old
  generation serving throughout). The new store starts clean (epoch 0, its
  own promotion thread); the old one closes after the drain.
  Bit-neutral: hot or cold placement never changes an answer.
* `reshard(None)` restages every single-tier random effect of a one-shard
  bundle as one shard, in a new buffer on its device, as the reference's
  does on one device (`plan_reshard`: no row moves, 0 bytes across the
  wire), through the same sequence (kind "reshard").

Not ported (ROADMAP item 9c): a reshard onto two or more cards
(`reshard(new_mesh)` with a mesh, `plan_reshard` across cards): they
raise. Bundles staged in row blocks (a multi-host worker's placement) are
refused, as the delta apply refuses to move their rows.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.serving.bundle import (
    ServingBundle,
    ServingCoordinate,
    ShardHealth,
    TwoTierEntityStore,
)
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)

_ACROSS_CARDS = "a reshard onto two or more cards is ROADMAP item 9c (not ported)"


def _reshard_policy():
    """1 + PHOTON_RESHARD_RETRIES attempts under the standard backoff."""
    return faults.bounded_policy(int(get_knob("PHOTON_RESHARD_RETRIES")))


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    """A reshard's row movement. On one card the shard-tracked random
    effects (`coordinates`) are restaged as one shard each on the device
    that holds them: no row moves."""

    coordinates: Tuple[str, ...]
    old_shards: int = 1
    new_shards: int = 1
    moved_rows: int = 0
    moved_bytes: int = 0


def plan_reshard(bundle: ServingBundle, new_mesh=None) -> ReshardPlan:
    """The bundle-wide plan: every single-tier random effect (fixed effects
    and two-tier stores carry over untouched). A mesh of cards raises (item
    9c), and so does a coordinate staged in row blocks or quantized (the
    restage copies float32 rows)."""
    if new_mesh is not None:
        raise NotImplementedError(f"plan_reshard: {_ACROSS_CARDS}")
    cids = []
    for c in bundle.coordinates.values():
        if not c.is_random_effect or c.store is not None or c.shard_health is None:
            continue
        if c.tier != "f32":
            raise ValueError(f"coordinate {c.cid!r} is quantized to {c.tier!r} — resharding "
                             "requires full-precision rows (restore_bundle_precision first)")
        if c.row_blocks is not None or c.shard_health.n_shards != 1:
            raise ValueError(f"coordinate {c.cid!r} is staged in {c.shard_health.n_shards} row blocks "
                             "(a multi-host worker's placement); its placement changes by a restage")
        cids.append(c.cid)
    if not cids:
        raise ValueError("bundle has no shard-tracked random-effect coordinate to reshard "
                         "(two-tier stores rebalance instead; see rebalance())")
    return ReshardPlan(coordinates=tuple(cids))


def plan_rebalance(coord: ServingCoordinate, *, min_promotions: Optional[int] = None) -> Tuple[int, ...]:
    """The rows a rebalance should preload: those promoted at least
    `min_promotions` times (PHOTON_REBALANCE_MIN_PROMOTIONS), hottest first,
    cut to the hot set's capacity. Empty: nothing earned a move yet."""
    store = coord.store
    if store is None:
        raise ValueError(f"coordinate {coord.cid!r} has no two-tier store — only two-tier "
                         "coordinates carry the promotion stats a rebalance plan reads")
    floor = int(get_knob("PHOTON_REBALANCE_MIN_PROMOTIONS")) if min_promotions is None \
        else int(min_promotions)
    stats = store.promotion_stats()
    hot = sorted((r for r, n in stats.items() if n >= max(1, floor)), key=lambda r: (-stats[r], r))
    return tuple(hot[: store.capacity])


class MeshReshardOrchestrator:
    """One engine's placement changes (`engine.reshard_orchestrator`), each a
    generation change through the engine's BundleManager under its mutex,
    so a swap, a delta and a rebalance order instead of racing."""

    def __init__(self, engine):
        self.engine = engine
        self._reshards = 0
        self._rebalances = 0
        self._rollbacks = 0

    @property
    def reshards(self) -> int:
        return self._reshards

    @property
    def rebalances(self) -> int:
        return self._rebalances

    @property
    def rollbacks(self) -> int:
        return self._rollbacks

    def _run(self, old_state, stage, *, kind: str, drain_timeout_s: float) -> Dict[str, object]:
        manager = self.engine.bundle_manager
        try:
            return manager._stage_and_commit(old_state, stage, kind=kind,
                                             drain_timeout_s=drain_timeout_s)
        except BaseException:
            self._rollbacks += 1
            raise

    def reshard(self, new_mesh=None, *, drain_timeout_s: float = 30.0,
                plan: Optional[ReshardPlan] = None) -> Dict[str, object]:
        """Restage the engine's single-tier random effects as one shard each
        on its device under live traffic (`new_mesh=None`); a mesh of two or
        more cards raises (ROADMAP item 9c)."""
        if new_mesh is not None:
            raise NotImplementedError(f"reshard: {_ACROSS_CARDS}")
        engine = self.engine
        manager = engine.bundle_manager
        with manager.mutex:
            old_state = engine._state
            old_bundle = old_state.bundle
            if plan is None:
                plan = plan_reshard(old_bundle, new_mesh)
            telemetry.emit_event("reshard_start", old_shards=plan.old_shards,
                                 new_shards=plan.new_shards, moved_rows=plan.moved_rows,
                                 moved_bytes=plan.moved_bytes)
            dev = old_bundle.device

            def stage() -> ServingBundle:
                new_coords: Dict[str, ServingCoordinate] = {}
                for cid in old_bundle.coordinate_ids:
                    c = old_bundle.coordinates[cid]
                    if cid not in plan.coordinates:
                        new_coords[cid] = c  # one object serves both generations
                        continue
                    logical = c.unseen_row + 1

                    def attempt(rows=c.params[:logical], cid=cid):
                        # A new buffer beside the live one (a device copy: no
                        # row changes device).
                        faults.fault_point("reshard_stage")
                        with telemetry.span("reshard_stage", coordinate=cid, shard=0):
                            buf = rows.clone()
                            if dev.type == "cuda":
                                torch.cuda.synchronize(dev)
                            return buf

                    params = faults.retry(attempt, _reshard_policy(),
                                          label=f"reshard staging {cid} shard 0",
                                          counter="reshard_retries")
                    new_coords[cid] = ServingCoordinate(
                        cid, c.shard, params, norm=c.norm, random_effect_type=c.random_effect_type,
                        entity_index=c.entity_index, logical_rows=logical,
                        shard_health=ShardHealth(1, logical))
                return ServingBundle(task=old_bundle.task, coordinates=new_coords, device=dev,
                                     index_maps=old_bundle.index_maps, upload_bytes=plan.moved_bytes,
                                     provenance=dict(old_bundle.provenance))

            info = self._run(old_state, stage, kind="reshard", drain_timeout_s=drain_timeout_s)
            self._reshards += 1
            info.update(old_shards=plan.old_shards, new_shards=plan.new_shards,
                        moved_rows=plan.moved_rows, moved_bytes=plan.moved_bytes,
                        restaged_bytes=plan.moved_bytes)
            return info

    def rebalance(self, cid: str, *, min_promotions: Optional[int] = None,
                  drain_timeout_s: float = 30.0) -> Dict[str, object]:
        """Re-place a two-tier coordinate's hot set from its promotion stats
        (module docstring). Returns {"rebalanced_rows": 0, "committed":
        False, ...} without a flip when no row has earned a move."""
        engine = self.engine
        manager = engine.bundle_manager
        with manager.mutex:
            old_state = engine._state
            old_bundle = old_state.bundle
            c = old_bundle.coordinates[cid]
            hot_rows = plan_rebalance(c, min_promotions=min_promotions)
            old_store = c.store
            if not hot_rows:
                return {"rebalanced_rows": 0, "version": old_state.version, "committed": False}
            moved_bytes = len(hot_rows) * c.dim * 4
            telemetry.emit_event("reshard_start", old_shards=1, new_shards=1,
                                 moved_rows=len(hot_rows), moved_bytes=moved_bytes)
            staged: List[TwoTierEntityStore] = []

            def stage() -> ServingBundle:
                def attempt():
                    faults.fault_point("reshard_stage")
                    return TwoTierEntityStore(old_store.cold_matrix, old_store.capacity,
                                              old_bundle.device, preload_rows=hot_rows)

                with telemetry.span("reshard_stage", coordinate=cid, shard=0):
                    new_store = faults.retry(attempt, _reshard_policy(),
                                             label=f"rebalance staging {cid}",
                                             counter="reshard_retries")
                staged.append(new_store)
                new_coords = dict(old_bundle.coordinates)
                new_coords[cid] = ServingCoordinate(
                    cid, c.shard, new_store.hot, norm=c.norm, random_effect_type=c.random_effect_type,
                    entity_index=c.entity_index, logical_rows=c.logical_rows, store=new_store)
                if old_bundle.device.type == "cuda":
                    torch.cuda.synchronize(old_bundle.device)
                return ServingBundle(task=old_bundle.task, coordinates=new_coords,
                                     device=old_bundle.device, index_maps=old_bundle.index_maps,
                                     upload_bytes=moved_bytes, provenance=dict(old_bundle.provenance))

            info = self._run(old_state, stage, kind="rebalance", drain_timeout_s=drain_timeout_s)
            self._rebalances += 1
            faults.COUNTERS.increment("rebalanced_rows", len(hot_rows))
            info.update(old_shards=1, new_shards=1, moved_rows=len(hot_rows),
                        moved_bytes=moved_bytes, restaged_bytes=moved_bytes,
                        rebalanced_rows=len(hot_rows), preloaded_rows=list(staged[0].preloaded_rows))
            return info
