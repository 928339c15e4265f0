"""Live placement changes of a READY serving engine: reshard under traffic.

Port of `photon_ml_tpu/serving/reshard.py`: take an engine's random-effect
matrices from one layout to another over the cards of one process (shrink
onto fewer cards, regrow, collapse to replicated on the home card), or
re-place a two-tier store's hot rows, without failing a request.

* PLAN: `plan_reshard` / `plan_coordinate_reshard` give each coordinate's
  row movement between its current shards and the new mesh's
  (`ShardSegment`, `CoordinateReshardPlan`, `ReshardPlan`, the reference's
  dataclasses): the contiguous row segments tiling each new shard's block,
  each from an old shard, and whether it moves (its old and new cards
  differ: a plan compares card identities, `parallel.mesh.CardMesh.cards`,
  as the reference's compares device objects). Only logical rows move;
  padding (rows at or past E + 1) never does. `moved_rows`/`moved_bytes`
  are what the journal records.
* STAGE: each new shard's block is built on its card beside the live
  generation (`_stage_resharded_params`), under the `reshard_stage` fault
  site with PHOTON_RESHARD_RETRIES bounded retries (`reshard_retries`): a
  segment whose card changes is copied card to card, every other one on
  its card, and the padding stays zeros. The live blocks are only read.
* PRE-WARM, COMMIT, FLIP: the port's one sequence,
  `BundleManager._stage_and_commit` (kind "reshard": the compatibility
  check, which lets a coordinate change between "re" and "re_sh", every
  bucket program of the new generation pre-warmed, the `reshard_commit`
  site, `reshard_start`/`reshard_commit` journal lines with the shard
  counts, the atomic flip, the drain, the old generation's release). Any
  failure before the flip rolls back (`reshard_rollback`,
  `reshard_rollbacks`) with the old generation serving throughout.

`plan_rebalance` / `MeshReshardOrchestrator.rebalance(cid)`: a two-tier
coordinate's `TwoTierEntityStore` counts each row's promotions; the rows
promoted at least PHOTON_REBALANCE_MIN_PROMOTIONS times, hottest first, cut
to the hot set's capacity, become the preload of a NEW store over the same
host rows, staged and flipped through the same sequence (kind
"rebalance"). Bit-neutral: placement never changes an answer.

Refused: a quantized coordinate (restore its precision first), and one
staged in row blocks on one device (a multi-host worker's placement, which
changes by a restage, as the delta apply refuses to move its rows).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import torch

from photon_ml_tpu_torch.parallel.mesh import CardMesh, RowShardedMatrix, card_of, pad_rows_for_mesh
from photon_ml_tpu_torch.serving.bundle import (
    ServingBundle,
    ServingCoordinate,
    ShardHealth,
    TwoTierEntityStore,
)
from photon_ml_tpu_torch.utils import faults, telemetry
from photon_ml_tpu_torch.utils.knobs import get_knob

logger = logging.getLogger(__name__)


def _reshard_policy():
    """1 + PHOTON_RESHARD_RETRIES attempts under the standard backoff."""
    return faults.bounded_policy(int(get_knob("PHOTON_RESHARD_RETRIES")))


@dataclasses.dataclass(frozen=True)
class ShardSegment:
    """Rows [row_lo, row_hi) of a new shard's block, from old shard
    `source_shard` (-1: padding that exists only in the new layout).
    `moves`: the old and new cards differ."""

    row_lo: int
    row_hi: int
    source_shard: int
    moves: bool

    @property
    def rows(self) -> int:
        return self.row_hi - self.row_lo


@dataclasses.dataclass(frozen=True)
class CoordinateReshardPlan:
    """One random-effect coordinate's row movement."""

    cid: str
    old_shards: int
    new_shards: int
    logical_rows: int  # E + 1, the pinned zero row included
    padded_rows: int  # rows of the new layout (a mesh multiple)
    dim: int
    # Per new shard: the ordered segments tiling its row block.
    segments: Tuple[Tuple[ShardSegment, ...], ...]
    moved_rows: int
    moved_bytes: int
    # Each old shard's request load (ShardHealth.loads).
    shard_loads: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    old_shards: int
    new_shards: int
    coordinates: Tuple[CoordinateReshardPlan, ...]

    @property
    def moved_rows(self) -> int:
        return sum(c.moved_rows for c in self.coordinates)

    @property
    def moved_bytes(self) -> int:
        return sum(c.moved_bytes for c in self.coordinates)


def _target(new_mesh: Optional[CardMesh]) -> Optional[CardMesh]:
    """A mesh of one shard is the replicated layout."""
    if new_mesh is not None and not isinstance(new_mesh, CardMesh):
        raise TypeError(f"new_mesh must be a parallel.mesh.CardMesh or None, got {type(new_mesh).__name__}")
    return new_mesh if new_mesh is not None and new_mesh.size > 1 else None


def _coord_cards(coord: ServingCoordinate) -> Tuple[int, ...]:
    """The card identity of each shard of a coordinate's current layout."""
    if coord.mesh is not None:
        return coord.mesh.cards
    return (card_of(coord.params.device),)


def plan_coordinate_reshard(coord: ServingCoordinate, new_mesh: Optional[CardMesh], *,
                            home=None) -> CoordinateReshardPlan:
    """One coordinate's row movement from its current shards to `new_mesh`
    (None: replicated on `home`, default the card the coordinate's first
    shard is on). A row moves when the card owning it in the new layout
    differs from the card holding it now; padding never moves."""
    if coord.shard_health is None:
        raise ValueError(f"coordinate {coord.cid!r} has no device-resident shard tracking "
                         "(fixed-effect or two-tier coordinate)")
    if coord.tier != "f32":
        raise ValueError(f"coordinate {coord.cid!r} is quantized to {coord.tier!r} — resharding "
                         "requires full-precision rows (restore_bundle_precision first)")
    if coord.row_blocks is not None:
        raise ValueError(f"coordinate {coord.cid!r} is staged in {coord.shard_health.n_shards} row "
                         "blocks (a multi-host worker's placement); its placement changes by a restage")
    new_mesh = _target(new_mesh)
    old_cards = _coord_cards(coord)
    if new_mesh is None:
        if home is None:
            home = coord.mesh.devices[0] if coord.mesh is not None else coord.params.device
        new_cards: Tuple[int, ...] = (card_of(home),)
    else:
        new_cards = new_mesh.cards
    n_old, n_new = len(old_cards), len(new_cards)
    logical = coord.unseen_row + 1
    rows_per_old = coord.shard_health.rows_per_shard
    padded = pad_rows_for_mesh(logical, new_mesh) if new_mesh is not None else logical
    rows_per_new = padded // n_new
    old_rows_total = n_old * rows_per_old
    segments: List[Tuple[ShardSegment, ...]] = []
    moved = 0
    for k in range(n_new):
        lo, hi = k * rows_per_new, (k + 1) * rows_per_new
        segs: List[ShardSegment] = []
        r = lo
        while r < hi:
            if r >= old_rows_total:
                segs.append(ShardSegment(r, hi, -1, False))
                break
            j = r // rows_per_old
            seg_hi = min(hi, (j + 1) * rows_per_old, old_rows_total)
            moves = old_cards[j] != new_cards[k]
            segs.append(ShardSegment(r, seg_hi, j, moves))
            if moves:  # only logical rows move: old-layout padding is zeros
                moved += max(0, min(seg_hi, logical) - min(r, logical))
            r = seg_hi
        segments.append(tuple(segs))
    return CoordinateReshardPlan(cid=coord.cid, old_shards=n_old, new_shards=n_new, logical_rows=logical,
                                 padded_rows=padded, dim=coord.dim, segments=tuple(segments),
                                 moved_rows=moved, moved_bytes=moved * coord.dim * 4,
                                 shard_loads=coord.shard_health.loads)


def plan_reshard(bundle: ServingBundle, new_mesh: Optional[CardMesh]) -> ReshardPlan:
    """The bundle-wide plan: every shard-tracked random effect (replicated
    or row-sharded) replans onto `new_mesh` (None: replicated on the
    bundle's card); fixed effects and two-tier stores carry over. A mesh of
    another device kind than the bundle's is refused."""
    new_mesh = _target(new_mesh)
    if new_mesh is not None and new_mesh.device_type != bundle.device.type:
        raise ValueError(f"a mesh of {new_mesh.device_type} cards cannot serve a bundle on {bundle.device}")
    plans = [plan_coordinate_reshard(c, new_mesh, home=bundle.device)
             for c in bundle.coordinates.values()
             if c.is_random_effect and c.store is None and c.shard_health is not None]
    if not plans:
        raise ValueError("bundle has no shard-tracked random-effect coordinate to reshard "
                         "(two-tier stores rebalance instead; see rebalance())")
    return ReshardPlan(old_shards=max(p.old_shards for p in plans), new_shards=plans[0].new_shards,
                       coordinates=tuple(plans))


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


def _stage_resharded_params(coord: ServingCoordinate, cplan: CoordinateReshardPlan,
                            new_mesh: Optional[CardMesh], home: torch.device):
    """One coordinate's matrix in the new layout, beside the live one: each
    new shard's block built on its card under the `reshard_stage` site
    (bounded retries), its segments copied from the old blocks (card to
    card where `moves`, on the card otherwise), rows past the logical E + 1
    left zero. Returns a RowShardedMatrix, or the (E + 1, dim) replicated
    matrix on `home`."""
    old_blocks = coord.params.blocks if coord.mesh is not None else (coord.params,)
    rows_per_old = coord.shard_health.rows_per_shard
    devices = new_mesh.devices if new_mesh is not None else (home,)
    rows_per_new = cplan.padded_rows // cplan.new_shards
    logical = cplan.logical_rows
    blocks = []
    for k, dev in enumerate(devices):
        lo = k * rows_per_new

        def attempt(k=k, dev=dev, lo=lo):
            faults.fault_point("reshard_stage")
            block = torch.zeros((rows_per_new, cplan.dim), dtype=torch.float32, device=dev)
            for seg in cplan.segments[k]:
                hi = min(seg.row_hi, logical)
                if seg.source_shard < 0 or hi <= seg.row_lo:
                    continue  # padding: zeros in both layouts
                base = seg.source_shard * rows_per_old
                block[seg.row_lo - lo: hi - lo].copy_(
                    old_blocks[seg.source_shard][seg.row_lo - base: hi - base])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return block

        with telemetry.span("reshard_stage", coordinate=cplan.cid, shard=k):
            blocks.append(faults.retry(attempt, _reshard_policy(),
                                       label=f"reshard staging {cplan.cid} shard {k}",
                                       counter="reshard_retries"))
    if new_mesh is None:
        return blocks[0]
    return RowShardedMatrix(blocks, new_mesh, logical)


class MeshReshardOrchestrator:
    """One engine's placement changes (`engine.reshard_orchestrator`), each a
    generation change through the engine's BundleManager under its mutex,
    so a swap, a delta, a reshard and a rebalance order instead of racing."""

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

    def _run(self, old_state, stage, *, kind: str, drain_timeout_s: float,
             shards: Tuple[int, int] = (1, 1)) -> Dict[str, object]:
        manager = self.engine.bundle_manager
        try:
            return manager._stage_and_commit(old_state, stage, kind=kind,
                                             drain_timeout_s=drain_timeout_s, shards=shards)
        except BaseException:
            self._rollbacks += 1
            raise

    def reshard(self, new_mesh: Optional[CardMesh] = None, *, drain_timeout_s: float = 30.0,
                plan: Optional[ReshardPlan] = None) -> Dict[str, object]:
        """Move the engine's shard-tracked random effects onto `new_mesh`
        (None, or a mesh of one card: replicated on the engine's card)
        under live traffic: plan, `reshard_start`, stage each new block
        beside the live generation, then the generation-change sequence
        (module docstring). Returns its record with the plan's shard counts
        and moved rows and bytes."""
        new_mesh = _target(new_mesh)
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
            plan_by_cid = {p.cid: p for p in plan.coordinates}
            dev = old_bundle.device

            def stage() -> ServingBundle:
                new_coords: Dict[str, ServingCoordinate] = {}
                for cid in old_bundle.coordinate_ids:
                    c = old_bundle.coordinates[cid]
                    cplan = plan_by_cid.get(cid)
                    if cplan is None:
                        new_coords[cid] = c  # one object serves both generations
                        continue
                    params = _stage_resharded_params(c, cplan, new_mesh, dev)
                    new_coords[cid] = ServingCoordinate(
                        cid, c.shard, params, norm=c.norm, random_effect_type=c.random_effect_type,
                        entity_index=c.entity_index, logical_rows=cplan.logical_rows,
                        shard_health=ShardHealth(cplan.new_shards, cplan.padded_rows // cplan.new_shards),
                        mesh=new_mesh)
                return ServingBundle(task=old_bundle.task, coordinates=new_coords, device=dev,
                                     index_maps=old_bundle.index_maps, upload_bytes=plan.moved_bytes,
                                     provenance=dict(old_bundle.provenance))

            info = self._run(old_state, stage, kind="reshard", drain_timeout_s=drain_timeout_s,
                             shards=(plan.old_shards, plan.new_shards))
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
