"""Delta bundles: ship only what an incremental fit changed to a live engine.

Port of `photon_ml_tpu/serving/delta.py`, the serving half of continuous
refresh. `build_delta_bundle` diffs two fit states (game/incremental.py)
into the minimal payload: the changed and added random-effect rows and the
changed fixed-effect planes. `apply_delta` flips a live engine onto it
through the one generation-change sequence of `BundleManager`
(`_stage_and_commit`, kind "delta", the reference's reshard primitive):
staging under the `shard_upload` site, the compatibility check, the
pre-warm, the `reshard_commit` site, the atomic flip, the drain and the
retirement of the old generation. A failure before the flip rolls back to
the old generation, which never stopped serving, and journals
`delta_rollback`.

Staging never writes a tensor the live generation reads: a generation's
bucket programs (CUDA graphs on the card) capture its parameter tensors,
and a replaying graph or an in-flight batch would read half-written rows.
So each changed random effect gets a new matrix on the device (the
resident rows copied, the carried rows moved by the carry map, the changed
rows uploaded and written), each changed fixed effect a new plane, and the
pre-warm captures the new generation's graphs. A coordinate the delta does
not touch shares its tensor with the old generation (retiring a bundle
only drops references).

Row placement: new entities interleave into the sorted entity index, so
carried rows can move although their floats do not change. Per
coordinate, the bundle carries the changed rows (the bytes that cross to
the device) and a carry map (old row -> new row), applied as a gather on
the device, so the upload is proportional to the churn. An unchanged index
stores no map.

What each of the reference's branches is here: the replicated single-tier
branch and the two-tier branch (the cold matrix rebuilt in host RAM, carry
and scatter there, and a new store of the same capacity staged; the old
store closes with its generation, a staged one on a rollback) are ported.
A bundle staged with `row_blocks=S` (the reference's mesh blocks on one
card) follows the reference's mesh rules: growth must fit the blocks'
padding, and a delta that re-sorts carried rows is refused (placement
changes through a restage, not a delta). `apply_delta_for_tenant` flips one
tenant of a `TenantRegistry`; its co-batch programs are captured in the
same pre-warm, before the commit.

Provenance: a committed apply updates the live bundle's lineage block in
place (origin "incremental", deltas_applied + 1, last_delta_source/ts) and
journals `delta_apply`; it counts `delta_applies` and `delta_rows_staged`,
and `engine.metrics()["bundle_deltas"]`.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.contracts import DELTA_BUNDLE_KEYS
from photon_ml_tpu_torch.game.incremental import FitState, grow_random_effect_model
from photon_ml_tpu_torch.game.model import FixedEffectModel, RandomEffectModel
from photon_ml_tpu_torch.serving.bundle import (
    ServingBundle,
    ServingCoordinate,
    ShardHealth,
    TwoTierEntityStore,
    _stage_shard,
)
from photon_ml_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CoordinateDelta:
    """One coordinate's update payload (host arrays). A fixed effect's
    `plane` is its whole new (dim,) weight vector. A random effect's
    `rows`/`values` are the changed and added rows in the new index's row
    space, `carry_old`/`carry_new` map every carried row's old position to
    its new one (None where no row moves), and `entity_index`/
    `logical_rows` are the coordinate's new host index and E + 1."""

    cid: str
    plane: Optional[np.ndarray] = None
    rows: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    carry_old: Optional[np.ndarray] = None
    carry_new: Optional[np.ndarray] = None
    entity_index: Optional[Dict[object, int]] = None
    logical_rows: Optional[int] = None

    @property
    def is_random_effect(self) -> bool:
        return self.plane is None

    @property
    def nbytes(self) -> int:
        return int(self.plane.nbytes if self.plane is not None else self.values.nbytes)

    @property
    def n_rows(self) -> int:
        return 0 if self.rows is None else int(len(self.rows))


@dataclasses.dataclass(frozen=True)
class DeltaBundle:
    """The refresh payload between two fits (manifest keys:
    contracts.DELTA_BUNDLE_KEYS)."""

    source: str
    mode: str
    coordinates: Dict[str, CoordinateDelta]
    delta_rows: int
    total_rows: int

    @property
    def nbytes(self) -> int:
        return sum(d.nbytes for d in self.coordinates.values())

    @property
    def is_empty(self) -> bool:
        return not self.coordinates

    def manifest(self) -> Dict[str, object]:
        """The DELTA_BUNDLE_KEYS summary journals and the refresh summary
        carry."""
        out = {
            "source": self.source,
            "mode": self.mode,
            "coordinates": {cid: {"kind": "re" if d.is_random_effect else "fe", "rows": d.n_rows}
                            for cid, d in self.coordinates.items()},
            "delta_rows": int(self.delta_rows),
            "total_rows": int(self.total_rows),
            "bytes": int(self.nbytes),
        }
        assert tuple(out) == DELTA_BUNDLE_KEYS
        return out


def build_delta_bundle(prev: FitState, new: FitState, *, source: str, mode: str = "delta",
                       delta_rows: int = 0, total_rows: int = 0) -> DeltaBundle:
    """Diff two fit states into the update payload, in the new index's row
    space: a coordinate the incremental fit carried contributes nothing, a
    changed random effect exactly its rows that differ from the previous
    model's (grown to the new index on the device), and carried rows that
    only moved ride the carry map."""
    coords: Dict[str, CoordinateDelta] = {}
    for cid in new.model.coordinate_ids:
        pm, nm = prev.model[cid], new.model[cid]
        if isinstance(nm, FixedEffectModel):
            new_plane = np.ascontiguousarray(nm.coefficients.means.detach().cpu().numpy(), np.float32)
            old_plane = pm.coefficients.means.detach().cpu().numpy().astype(np.float32)
            if new_plane.shape == old_plane.shape and np.array_equal(new_plane, old_plane):
                continue
            coords[cid] = CoordinateDelta(cid, plane=new_plane)
            continue
        if not isinstance(nm, RandomEffectModel):
            raise TypeError(f"unknown model type {type(nm)} for {cid!r}")
        prev_idx = prev.entity_indices[cid]
        new_idx = new.entity_indices[cid]
        grown = pm if prev_idx == new_idx else grow_random_effect_model(pm, prev_idx, new_idx)
        e_new = len(new_idx)
        new_mat = nm.coefficients_matrix[: e_new + 1]
        old_mat = grown.coefficients_matrix[: e_new + 1].to(new_mat.device)
        changed = torch.nonzero((new_mat != old_mat).any(dim=1)).flatten()
        # A new entity whose solve stayed at zero still needs its index
        # entry; the row payload covers changed values only.
        if changed.numel() == 0 and prev_idx == new_idx:
            continue
        carry_old = carry_new = None
        if prev_idx != new_idx:
            shared = [k for k in new_idx if k in prev_idx]
            carry_old = np.fromiter((prev_idx[k] for k in shared), np.int64, len(shared))
            carry_new = np.fromiter((new_idx[k] for k in shared), np.int64, len(shared))
            if np.array_equal(carry_old, carry_new):
                carry_old = carry_new = None  # a pure append: no row moves
        coords[cid] = CoordinateDelta(
            cid, rows=changed.cpu().numpy().astype(np.int64),
            values=np.ascontiguousarray(new_mat[changed].detach().cpu().numpy(), np.float32),
            carry_old=carry_old, carry_new=carry_new, entity_index=dict(new_idx),
            logical_rows=e_new + 1)
    return DeltaBundle(source, mode, coords, int(delta_rows), int(total_rows))


def _apply_re_delta(c: ServingCoordinate, d: CoordinateDelta, device: torch.device) -> ServingCoordinate:
    """Stage one random effect's next generation from its resident matrix
    and the delta rows, in a new tensor (the module docstring)."""
    old = c.params
    rows = torch.as_tensor(d.rows)
    if c.store is not None:
        # Two-tier: the cold matrix is host RAM, so carry and scatter there
        # and stage a new store beside the live one.
        old_cold = c.store.cold_matrix
        new_cold = np.zeros((d.logical_rows, old_cold.shape[1]), np.float32)
        if d.carry_old is None:
            n = min(int(old_cold.shape[0]), d.logical_rows)
            new_cold[:n] = old_cold[:n]
        else:
            new_cold[d.carry_new] = old_cold[d.carry_old]
        new_cold[d.rows] = d.values
        store = _stage_shard(f"{d.cid} (delta two-tier rebuild)",
                             lambda: TwoTierEntityStore(new_cold, c.store.capacity, device))
        return ServingCoordinate(d.cid, c.shard, store.hot, norm=c.norm,
                                 random_effect_type=c.random_effect_type, entity_index=d.entity_index,
                                 logical_rows=d.logical_rows, store=store)
    if c.row_blocks is not None:
        # The reference's mesh rules: growth must fit the blocks' padding and
        # carried rows keep their places (placement changes by a restage).
        physical = int(old.shape[0])
        if d.logical_rows > physical:
            raise ValueError(f"coordinate {d.cid!r}: delta grows logical rows to {d.logical_rows} "
                             f"past the mesh-padded {physical} — reshard to a larger padding "
                             "first, then apply")
        if d.carry_old is not None:
            raise ValueError(f"coordinate {d.cid!r}: delta re-sorts carried entity rows; an "
                             "entity-sharded matrix's row placement changes through reshard(), "
                             "not a delta apply")
        params = old.clone()
        shard_of = d.rows // c.shard_health.rows_per_shard
        for k in np.unique(shard_of):
            m = np.nonzero(shard_of == k)[0]

            def write(r=rows[m], v=torch.from_numpy(d.values[m])):
                params[r.to(device)] = v.to(device)
                return params

            _stage_shard(f"{d.cid} shard {int(k)} (delta rows)", write)
        return dataclasses.replace(c, params=params, entity_index=d.entity_index,
                                   logical_rows=d.logical_rows)

    def stage() -> torch.Tensor:
        new = old.new_zeros((d.logical_rows, old.shape[1]))
        if d.carry_old is None:
            n = min(int(old.shape[0]), d.logical_rows)
            new[:n] = old[:n]
        else:
            new[torch.as_tensor(d.carry_new).to(device)] = old[torch.as_tensor(d.carry_old).to(device)]
        new[rows.to(device)] = torch.from_numpy(d.values).to(device)
        return new

    params = _stage_shard(f"{d.cid} (delta rows)", stage)
    return ServingCoordinate(d.cid, c.shard, params, norm=c.norm,
                             random_effect_type=c.random_effect_type, entity_index=d.entity_index,
                             shard_health=ShardHealth(1, d.logical_rows), logical_rows=d.logical_rows)


def apply_delta(engine, delta: DeltaBundle, *, drain_timeout_s: float = 30.0) -> Dict[str, object]:
    """Flip a live engine onto a delta bundle: a generation change through
    `BundleManager._stage_and_commit` (kind "delta"). The old generation
    answers every in-flight and concurrent request until the flip, and keeps
    serving if anything before it fails. An empty bundle commits nothing.
    Returns the sequence's record plus `delta_rows_staged` and
    `restaged_bytes`."""
    if delta.is_empty:
        return {"version": engine.bundle_version, "committed": False, "delta_rows_staged": 0,
                "restaged_bytes": 0}
    manager = engine.bundle_manager
    with manager.mutex:
        old_state = engine._state
        old_bundle = old_state.bundle
        missing = [c for c in delta.coordinates if c not in old_bundle.coordinates]
        if missing:
            raise ValueError(f"delta bundle targets unknown coordinates {missing!r}")
        dev = old_bundle.device

        def stage() -> ServingBundle:
            t0 = time.perf_counter()
            new_coords = dict(old_bundle.coordinates)
            try:
                for cid, d in delta.coordinates.items():
                    c = old_bundle.coordinates[cid]
                    with telemetry.span("delta_stage", coordinate=cid):
                        if d.is_random_effect:
                            new_coords[cid] = _apply_re_delta(c, d, dev)
                        else:
                            params = _stage_shard(f"{cid} (delta fixed-effect plane)",
                                                  lambda p=d.plane: torch.from_numpy(p).to(dev).clone())
                            new_coords[cid] = ServingCoordinate(cid, c.shard, params, norm=c.norm)
            except BaseException:
                for cid, c in new_coords.items():  # stores this staging made
                    if c.store is not None and c is not old_bundle.coordinates[cid]:
                        c.store.close()
                raise
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return ServingBundle(task=old_bundle.task, coordinates=new_coords, device=dev,
                                 index_maps=old_bundle.index_maps, upload_bytes=delta.nbytes,
                                 upload_s=time.perf_counter() - t0,
                                 provenance=dict(old_bundle.provenance))

        info = manager._stage_and_commit(old_state, stage, kind="delta",
                                         drain_timeout_s=drain_timeout_s)
        n_rows = sum(d.n_rows for d in delta.coordinates.values())
        faults.COUNTERS.increment("delta_applies")
        if n_rows:
            faults.COUNTERS.increment("delta_rows_staged", n_rows)
        live = engine.bundle
        live.provenance["origin"] = "incremental"
        live.provenance["deltas_applied"] = int(live.provenance.get("deltas_applied", 0)) + 1
        live.provenance["last_delta_source"] = delta.source
        live.provenance["last_delta_ts"] = time.time()
        telemetry.emit_event("delta_apply", version=info["version"],
                             coordinates=sorted(delta.coordinates), rows=int(n_rows),
                             bytes=int(delta.nbytes), source=delta.source)
        logger.info("delta bundle applied: generation %d -> %d (%d rows, %d bytes, source %s)",
                    info["previous_version"], info["version"], n_rows, delta.nbytes, delta.source)
        info["delta_rows_staged"] = int(n_rows)
        info["restaged_bytes"] = int(delta.nbytes)
        return info


def apply_delta_for_tenant(registry, name: str, delta: DeltaBundle, *,
                           drain_timeout_s: float = 30.0) -> Dict[str, object]:
    """Per-tenant refresh: flip one tenant's engine onto a delta bundle.
    Tenant engines share the card's device mutex, so the flip serializes
    with every other tenant's dispatch, and it touches no other tenant's
    generation."""
    return apply_delta(registry.tenant(name).engine, delta, drain_timeout_s=drain_timeout_s)
