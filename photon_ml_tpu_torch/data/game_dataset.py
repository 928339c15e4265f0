"""GAME datasets: columnar samples plus the entity-blocked random-effect layout.

Port of the dense, host-assembled path of `photon_ml_tpu/data/game_dataset.py`.
Every sample sits at a fixed slot of one sample axis on the device. A
fixed-effect view is (shard features, labels, offsets, weights). A
random-effect view is built once on the host as *entity blocks*: entities
bucketed by padded size (power-of-two capacities from `min_bucket`), each
bucket a (E, S) gather matrix into the sample axis plus a validity mask, so
training gathers dense (E, S, D) blocks and solves all E problems at once.
Rows past an entity's `active_upper_bound` are left out of training by a
deterministic splitmix64 reservoir and still scored. The layout is the JAX
package's exactly: same entities per bucket, same gather rows.

A shard is a dense (N, D) tensor or an ELL `SparseFeatures`; a sparse
shard's layout (data/sparse_layout.py: CSR in row tiles, and CSC only above
a single-stream width) is built on the device once, at first use, and
cached on the dataset.

A dataset sharded over torch.distributed ranks (`parallel/mesh.py
shard_game_dataset`) holds only this rank's rows, in global order, and
carries a `sharding` that maps them to their global positions; its
random-effect layout is this rank's part of the layout built from the
global id tag.

Not ported yet: random effects over sparse shards, Pearson feature masks,
projectors, the device-side assembly and the async packing of the JAX data
plane.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import Features, LabeledData, SparseFeatures
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout, from_ell
from photon_ml_tpu_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RankMesh, RowSharding

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """active_upper_bound caps the rows per entity used for training (the
    rest are scored only); active_lower_bound drops entities with fewer rows
    from training; min_bucket is the smallest padded block size;
    max_block_cells bounds entities x capacity per training block."""

    random_effect_type: str
    feature_shard: str
    active_upper_bound: Optional[int] = None
    active_lower_bound: Optional[int] = None
    min_bucket: int = 8
    max_block_cells: int = 1 << 21


@dataclasses.dataclass
class GameDataset:
    """Columnar GAME data in fixed sample order. `id_tags` are host-side
    per-sample entity keys (numpy); everything else lives on `device`."""

    shards: Dict[str, Features]
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    id_tags: Dict[str, np.ndarray]
    # Per-dataset derived representations (a coordinate's bf16 copy of a
    # shard, a sparse shard's layout), built once and shared by the
    # coordinates and scorers over it.
    cache: Dict[object, object] = dataclasses.field(default_factory=dict)
    # Set on a dataset that holds one rank's rows (parallel/mesh.py).
    sharding: Optional["RowSharding"] = None

    @property
    def num_samples(self) -> int:
        return int(self.labels.shape[0])

    @property
    def mesh(self) -> Optional["RankMesh"]:
        return None if self.sharding is None else self.sharding.mesh

    @property
    def device(self) -> torch.device:
        return self.labels.device

    def sparse_layout(self, shard: str) -> SparseLayout:
        """The layout of a sparse shard (CSC only where a route reads it), built
        on first use."""
        key = ("sparse_layout", shard)
        if key not in self.cache:
            feats = self.shards[shard]
            if not isinstance(feats, SparseFeatures):
                raise TypeError(f"shard {shard!r} is not sparse")
            self.cache[key] = from_ell(feats)
        return self.cache[key]

    @classmethod
    def build(
        cls,
        shards: Mapping[str, object],
        labels,
        *,
        offsets=None,
        weights=None,
        id_tags: Optional[Mapping[str, Sequence]] = None,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
    ) -> "GameDataset":
        """From host arrays (numpy or tensors; a sparse shard is a
        `SparseFeatures`); everything is moved to `device` once here."""
        dev = resolve_device(device)
        as_t = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a)
        labels_t = as_t(labels).to(dtype=dtype, device=dev)
        n = labels_t.shape[0]
        off = (torch.zeros(n, dtype=dtype, device=dev) if offsets is None
               else as_t(offsets).to(dtype=dtype, device=dev))
        wt = (torch.ones(n, dtype=dtype, device=dev) if weights is None
              else as_t(weights).to(dtype=dtype, device=dev))
        feats = {}
        for name, X in shards.items():
            if isinstance(X, SparseFeatures):
                feats[name] = _sparse_shard(name, X, n, dev)
                continue
            Xt = as_t(X).to(device=dev)
            if Xt.ndim != 2 or Xt.shape[0] != n:
                raise ValueError(f"shard {name!r} must be ({n}, d), got {tuple(Xt.shape)}")
            if not Xt.is_floating_point():
                raise TypeError(f"shard {name!r} must be floating point, got {Xt.dtype}")
            feats[name] = Xt.contiguous()
        tags = {k: np.asarray(v) for k, v in (id_tags or {}).items()}
        for k, v in tags.items():
            if len(v) != n:
                raise ValueError(f"id tag {k!r} has {len(v)} values for {n} samples")
        return cls(feats, labels_t, off, wt, tags)


def _sparse_shard(name: str, X: SparseFeatures, n: int, dev: torch.device) -> SparseFeatures:
    idx, val = torch.as_tensor(X.indices), torch.as_tensor(X.values)
    if idx.ndim != 2 or idx.shape != val.shape or idx.shape[0] != n:
        raise ValueError(f"sparse shard {name!r} must be ({n}, K) ELL planes, "
                         f"got {tuple(idx.shape)} and {tuple(val.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sparse shard {name!r} indices must be int32/int64, got {idx.dtype}")
    if val.dtype != torch.float32:
        raise TypeError(f"sparse shard {name!r} values must be float32, got {val.dtype}")
    return SparseFeatures(idx.to(dev).contiguous(), val.to(dev).contiguous(), int(X.dim))


def _row_priorities(codes: np.ndarray, n: int) -> np.ndarray:
    """Deterministic per-(entity, row) reservoir priorities: a splitmix64
    mix of the entity code and the row index. Over-cap entities keep the
    `cap` rows with the smallest priorities."""
    x = codes.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    x += np.arange(n, dtype=np.uint64) * np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class EntityBlocks:
    """One padded bucket of entities with equal block capacity."""

    def __init__(self, gather: np.ndarray, mask: np.ndarray, entity_rows: np.ndarray,
                 device: torch.device):
        self.gather = torch.as_tensor(gather, dtype=torch.int64).to(device)  # (E, S)
        self.mask = torch.as_tensor(mask, dtype=torch.float32).to(device)  # (E, S)
        self.entity_rows = torch.as_tensor(entity_rows, dtype=torch.int64).to(device)  # (E,)

    @property
    def num_entities(self) -> int:
        return int(self.gather.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.gather.shape[1])


@dataclasses.dataclass
class RandomEffectDataset:
    """Entity-blocked view of a GameDataset for one random-effect coordinate.

    `entity_index`: entity key -> row of the coefficient matrix.
    `buckets`: padded gather blocks for training (active rows only).
    `sample_entity_rows`: each sample's coefficient row for scoring.
    `owned_entities`: on a rank, the entities (rows of the global matrix)
    it owns and trains, increasing; its coefficient store holds their rows
    alone, row i for `owned_entities[i]`, and the bucket and sample rows
    index that store (None: every entity, one process)."""

    config: RandomEffectDataConfig
    entity_index: Dict[object, int]
    buckets: List[EntityBlocks]
    sample_entity_rows: Tensor  # (N,) int64
    num_active_samples: int
    num_passive_samples: int
    owned_entities: Optional[Tensor] = None

    @property
    def num_entities(self) -> int:
        return len(self.entity_index)

    @property
    def num_store_rows(self) -> int:
        """Entity rows of the coefficient store this dataset trains (its
        pinned zero row comes after them)."""
        return self.num_entities if self.owned_entities is None else len(self.owned_entities)

    @property
    def feature_shard(self) -> str:
        return self.config.feature_shard


@dataclasses.dataclass
class EntityLayout:
    """The entity-blocked layout on the host, before any device copy.

    `codes` is each sample's entity code (its coefficient row); `blocks`
    holds one (gather (E, S), mask (E, S), entity_rows (E,)) numpy triple
    per padded bucket chunk, gathers indexing the sample axis the layout
    was built from."""

    entity_index: Dict[object, int]
    codes: np.ndarray
    blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
    num_active: int

    @property
    def num_entities(self) -> int:
        return len(self.entity_index)


def entity_layout(keys: np.ndarray, config: RandomEffectDataConfig) -> EntityLayout:
    """Host-side construction of the entity-blocked layout from the id tag
    of every sample."""
    n = len(keys)
    uniq, codes = np.unique(keys, return_inverse=True)
    codes = codes.reshape(-1)
    num_entities = len(uniq)
    counts = np.bincount(codes, minlength=num_entities)
    entity_index: Dict[object, int] = {
        (k.item() if hasattr(k, "item") else k): i for i, k in enumerate(uniq)
    }

    lower = config.active_lower_bound or 0
    cap = config.active_upper_bound
    a_counts = counts.copy()
    if lower:
        a_counts[counts < lower] = 0
    if cap is not None:
        np.minimum(a_counts, cap, out=a_counts)
    need_reservoir = cap is not None and bool((counts > cap).any())
    num_active = int(a_counts.sum())
    kept = np.nonzero(a_counts > 0)[0]
    kept_sizes = a_counts[kept]

    # Active rows sorted by (entity, row); over-cap entities keep their
    # smallest-priority rows, restored to row order.
    if need_reservoir:
        order = np.lexsort((_row_priorities(codes, n), codes))
    else:
        order = np.argsort(codes, kind="stable")
    if need_reservoir or lower or cap is not None:
        starts1 = np.zeros(num_entities + 1, np.int64)
        np.cumsum(counts, out=starts1[1:])
        rank = np.arange(n, dtype=np.int64) - starts1[codes[order]]
        active_rows = order[rank < a_counts[codes[order]]]
        if need_reservoir:
            active_rows = active_rows[np.lexsort((active_rows, codes[active_rows]))]
    else:
        active_rows = order

    # Bucket by padded capacity: the power of two (times min_bucket) >= size.
    min_b = max(config.min_bucket, 1)
    pows = min_b * (1 << np.arange(0, 40, dtype=np.int64))
    pows = pows[pows < (1 << 40)]
    cap_of_kept = pows[np.searchsorted(pows, kept_sizes)]

    a_starts = np.zeros(len(kept) + 1, np.int64)
    np.cumsum(kept_sizes, out=a_starts[1:])
    row_kept_ord = np.repeat(np.arange(len(kept), dtype=np.int64), kept_sizes)
    row_pos = np.arange(num_active, dtype=np.int64) - a_starts[row_kept_ord]

    blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for capacity in np.unique(cap_of_kept) if len(kept) else []:
        members = np.nonzero(cap_of_kept == capacity)[0]
        e = len(members)
        local = np.full(len(kept), -1, np.int64)
        local[members] = np.arange(e)
        ent_rows = kept[members]
        max_e = max(1, int(config.max_block_cells) // int(capacity))
        # Canonical entity counts: one chunk of the next power of two >= e
        # (at least 8), or equal chunks of max_e, padded with inert dummies
        # (gather row 0, mask 0, entity row = the pinned zero row).
        n_chunks = -(-e // max_e)
        if n_chunks == 1:
            target = 8
            while target < e:
                target *= 2
            target = min(target, max_e)
        else:
            target = max_e
        pad_e = n_chunks * target - e
        in_bucket = local[row_kept_ord] >= 0
        gather = np.zeros((e + pad_e, int(capacity)), np.int64)
        mask = np.zeros((e + pad_e, int(capacity)), np.float32)
        li = local[row_kept_ord[in_bucket]]
        pj = row_pos[in_bucket]
        gather[li, pj] = active_rows[in_bucket]
        mask[li, pj] = 1.0
        if pad_e:
            ent_rows = np.concatenate([ent_rows, np.full(pad_e, num_entities, np.int64)])
        for c in range(n_chunks):
            sl = slice(c * target, (c + 1) * target)
            blocks.append((gather[sl], mask[sl], ent_rows[sl]))
    return EntityLayout(entity_index, codes.astype(np.int64), blocks, num_active)


def build_random_effect_dataset(
    dataset: GameDataset, config: RandomEffectDataConfig
) -> RandomEffectDataset:
    """One-time construction of the entity-blocked layout: on the host from
    the dataset's id tag, or, for a dataset sharded over ranks, this rank's
    part of the layout built from the global id tag (parallel/mesh.py)."""
    tag = config.random_effect_type
    if isinstance(dataset.shards[config.feature_shard], SparseFeatures):
        raise NotImplementedError("random effects over sparse shards are not ported yet")
    if tag not in dataset.id_tags:
        raise ValueError(f"id tag {tag!r} not present in dataset")
    if dataset.sharding is not None:
        return dataset.sharding.random_effect_dataset(dataset, config)
    layout = entity_layout(dataset.id_tags[tag], config)
    dev = dataset.device
    return RandomEffectDataset(
        config=config,
        entity_index=layout.entity_index,
        buckets=[EntityBlocks(g, m, e, dev) for g, m, e in layout.blocks],
        sample_entity_rows=torch.as_tensor(layout.codes).to(dev),
        num_active_samples=layout.num_active,
        num_passive_samples=dataset.num_samples - layout.num_active,
    )


def gather_block_data(
    dataset: GameDataset,
    shard: str,
    blocks: EntityBlocks,
    offsets: Optional[Tensor] = None,
) -> LabeledData:
    """The (E, S, ...) LabeledData of one bucket; padding slots get weight
    0. Offsets default to the dataset's; coordinate descent passes the
    residual-adjusted ones."""
    offs = dataset.offsets if offsets is None else offsets
    g = blocks.gather
    return LabeledData(
        features=dataset.shards[shard][g],
        labels=dataset.labels[g],
        offsets=offs[g],
        weights=dataset.weights[g] * blocks.mask,
    )
