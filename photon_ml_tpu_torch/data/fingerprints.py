"""Per-coordinate and per-entity data fingerprints for incremental refresh.

Port of `photon_ml_tpu/data/fingerprints.py`. A refresh round re-solves
only what its delta batch changed, and this module answers "did this
coordinate's training inputs change, and for which entities?" exactly:

* a fixed-effect coordinate's solve reads its whole shard plus the labels,
  offsets and weights, so its fingerprint is one digest over those planes
  in sample order; any appended or edited row changes it;
* a random-effect coordinate's per-entity solves are independent given the
  offsets, so its fingerprint is one digest per entity over that entity's
  rows (features, label, offset, weight, in sample order). A diff of two
  fingerprints gives exactly the churned and new entities.

Digests are blake2b (16 bytes) over the planes' bytes, never a float
tolerance: the refresh contract is "bit-equal data gives bit-equal carried
coefficients", so the change detector is exact too. The bytes hashed are
the reference's (an entity's rows of each plane, one plane after another),
so a dataset with the same planes in the same dtypes gets the same digests
in both packages.

Where the planes come from: the port's shards live on the device, so a
fingerprint copies each plane it reads to the host once (`.cpu()`: the
shard's ELL indices and values or dense matrix, the labels, offsets and
weights; a round at 3e's width moves about 0.34 GB). The entities are
grouped through the dataset's `tag_codes` (every port dataset has them), on
the host, by one stable sort of the codes; each plane is gathered in that
order once, so an entity's rows are one contiguous slice of it. `times`
(a `timing.StageTimes`) gets the copy's and the hashing's seconds apart.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    FixedEffectDataConfig,
    GameDataset,
    RandomEffectDataConfig,
)
from photon_ml_tpu_torch.timing import StageTimes

_DIGEST_SIZE = 16


def _normalize_key(k):
    """Numpy scalars unwrap to their Python value, so fingerprint keys and
    entity-index keys compare equal."""
    return k.item() if hasattr(k, "item") else k


def _host(t) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


def entity_groups(dataset: GameDataset, tag: str) -> Tuple[list, np.ndarray, np.ndarray]:
    """(keys, order, bounds) of one id tag: the entity keys in sorted order
    (the entity index's order; only values some sample uses), the sample
    rows grouped by entity (stable, so each entity's rows stay in sample
    order) and each entity's [bounds[i], bounds[i + 1]) slice of them."""
    codes, table = dataset.tag_codes[tag]
    counts = np.bincount(codes, minlength=len(table))
    used = counts > 0
    # The narrowest integer type of the entity codes: numpy's stable sort
    # is a radix sort up to 16 bits (a few times faster at 10^6 rows).
    inv = (np.cumsum(used) - 1).astype(np.min_scalar_type(max(int(used.sum()) - 1, 0)))[codes]
    order = np.argsort(inv, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(counts[used])])
    return [_normalize_key(k) for k in table[used]], order, bounds


def _update(h, planes, lo: int, hi: int) -> None:
    """Fold rows [lo, hi) of each plane into digest `h`, plane by plane."""
    for p in planes:
        h.update(p[lo:hi])


@dataclasses.dataclass(frozen=True)
class CoordinateFingerprint:
    """One coordinate's data fingerprint: `digest` covers the whole
    coordinate; `entity_digests`/`entity_rows` are a random effect's
    per-entity digests and row counts (None for a fixed effect)."""

    digest: str
    entity_digests: Optional[Dict[object, str]] = None
    entity_rows: Optional[Dict[object, int]] = None

    @property
    def is_random_effect(self) -> bool:
        return self.entity_digests is not None


@dataclasses.dataclass(frozen=True)
class DatasetFingerprints:
    """Per-coordinate fingerprints of one GameDataset snapshot."""

    num_samples: int
    coordinates: Dict[str, CoordinateFingerprint]


def fingerprint_dataset(dataset: GameDataset, data_configs: Mapping[str, object],
                        times: Optional[StageTimes] = None) -> DatasetFingerprints:
    """Fingerprint every coordinate's training inputs. `data_configs` maps
    coordinate id -> FixedEffectDataConfig | RandomEffectDataConfig.
    `times` gets `fingerprint_copy` (device to host) and `fingerprint_hash`."""
    times = StageTimes() if times is None else times
    planes: Dict[str, Tuple[np.ndarray, ...]] = {}
    with times.stage("fingerprint_copy"):
        common = tuple(_host(t) for t in (dataset.labels, dataset.offsets, dataset.weights))
        for cfg in data_configs.values():
            if not isinstance(cfg, (FixedEffectDataConfig, RandomEffectDataConfig)):
                raise TypeError(f"unknown data config {type(cfg)}")
            if cfg.feature_shard not in planes:
                feats = dataset.shards[cfg.feature_shard]
                shard = ((_host(feats.indices), _host(feats.values)) if isinstance(feats, SparseFeatures)
                         else (_host(feats),))
                planes[cfg.feature_shard] = shard + common
    coords: Dict[str, CoordinateFingerprint] = {}
    with times.stage("fingerprint_hash"):
        for cid, cfg in data_configs.items():
            rows = planes[cfg.feature_shard]
            if isinstance(cfg, FixedEffectDataConfig):
                h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
                _update(h, rows, 0, dataset.num_samples)
                coords[cid] = CoordinateFingerprint(h.hexdigest())
                continue
            keys, order, bounds = entity_groups(dataset, cfg.random_effect_type)
            grouped = [np.ascontiguousarray(p[order]) for p in rows]
            digests: Dict[object, str] = {}
            rows_per: Dict[object, int] = {}
            whole = hashlib.blake2b(digest_size=_DIGEST_SIZE)
            for i, key in enumerate(keys):
                h = hashlib.blake2b(digest_size=_DIGEST_SIZE)
                _update(h, grouped, int(bounds[i]), int(bounds[i + 1]))
                d = h.hexdigest()
                digests[key] = d
                rows_per[key] = int(bounds[i + 1] - bounds[i])
                whole.update(repr(key).encode())
                whole.update(d.encode())
            coords[cid] = CoordinateFingerprint(whole.hexdigest(), digests, rows_per)
    return DatasetFingerprints(dataset.num_samples, coords)


@dataclasses.dataclass(frozen=True)
class CoordinateDiff:
    """One coordinate's change between two snapshots. `changed_entities`
    are the churned (digest differs) and new keys of a random effect, in the
    new snapshot's sorted order, `new_entities` the new ones; both empty for
    a fixed effect. `delta_rows` counts the new snapshot's rows of the
    changed entities (random effect) or all its rows (a changed fixed
    effect)."""

    changed: bool
    changed_entities: Tuple[object, ...] = ()
    new_entities: Tuple[object, ...] = ()
    delta_rows: int = 0


def diff_fingerprints(prev: DatasetFingerprints,
                      new: DatasetFingerprints) -> Dict[str, CoordinateDiff]:
    """Per-coordinate diff. Refresh datasets are append/update-only: an
    entity of `prev` missing from `new` raises (the caller diffed against
    the wrong snapshot)."""
    if set(prev.coordinates) != set(new.coordinates):
        raise ValueError("fingerprints cover different coordinates: "
                         f"{sorted(prev.coordinates)} vs {sorted(new.coordinates)}")
    out: Dict[str, CoordinateDiff] = {}
    for cid, pf in prev.coordinates.items():
        nf = new.coordinates[cid]
        if pf.is_random_effect != nf.is_random_effect:
            raise ValueError(f"coordinate {cid!r} changed kind between snapshots")
        if not nf.is_random_effect:
            changed = pf.digest != nf.digest
            out[cid] = CoordinateDiff(changed, delta_rows=new.num_samples if changed else 0)
            continue
        missing = [k for k in pf.entity_digests if k not in nf.entity_digests]
        if missing:
            raise ValueError(f"coordinate {cid!r}: entities {missing[:5]!r} present in the previous "
                             "snapshot are missing from the new one — refresh datasets are "
                             "append/update-only")
        changed_keys = []
        new_keys = []
        for k, d in nf.entity_digests.items():
            pd = pf.entity_digests.get(k)
            if pd is None:
                changed_keys.append(k)
                new_keys.append(k)
            elif pd != d:
                changed_keys.append(k)
        out[cid] = CoordinateDiff(bool(changed_keys), tuple(changed_keys), tuple(new_keys),
                                  delta_rows=int(sum(nf.entity_rows[k] for k in changed_keys)))
    return out
