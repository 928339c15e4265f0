"""GAME datasets: columnar samples plus the entity-blocked random-effect layout.

Port of `photon_ml_tpu/data/game_dataset.py`. Every sample sits at a fixed
slot of one sample axis on the device. A fixed-effect view is (shard
features, labels, offsets, weights). A random-effect view is built once, on
the dataset's device (data/device_assemble.py), as *entity blocks*: entities
bucketed by padded size (power-of-two capacities from `min_bucket`), each
bucket a (E, S) gather matrix into the sample axis plus a validity mask, so
training gathers dense (E, S, D) blocks and solves all E problems at once.
Rows past an entity's `active_upper_bound` are left out of training by a
deterministic splitmix64 reservoir and still scored. The layout is the JAX
package's exactly: same entities per bucket, same gather rows.

A shard is a dense (N, D) tensor or an ELL `SparseFeatures`; a sparse
shard's layout (data/sparse_layout.py: CSR in row tiles, and CSC only above
a single-stream width) is built on the device once, at first use, and
cached on the dataset. A random effect over a sparse shard gathers an
(E, S, K) ELL block per bucket chunk; its coordinate makes the block dense
on the device (game/coordinate.py).

Every id tag is also held factorized, as `tag_codes` (per-sample codes into
a sorted value table): a dataset read from Avro (io/avro_data.py) gets them
from ingest, which sorts only the small value tables; `GameDataset.build`
factorizes any other tag once. The entity layout works from them. A dataset
read from Avro also carries `ingest_timing`, the stage times of that read.

A dataset sharded over torch.distributed ranks (`parallel/mesh.py
shard_game_dataset`) holds only this rank's rows, in global order, and
carries a `sharding` that maps them to their global positions; a random
effect's layout is this rank's part of the layout built from the global id
tag, over this rank's rows or, for a random effect other than the one the
rows follow, over a row view exchanged from the other ranks.

Pearson feature selection (`num_features_to_samples_ratio_upper_bound`)
runs on the host, as in the reference; on ranks, each rank computes the
masks of the entities it owns, whose active rows it holds. The estimator
projects each random effect's shard (game/projector.py) after its layout
is built.
`concat_datasets` appends datasets' rows (the multi-host ingest assembles
every rank's files with it), merging the id-tag tables, so the files read
one by one and concatenated give one read of them all; a refresh round
(game/incremental.py) merges its delta batch onto the previous rows with
it, and carves the changed entities' rows out with `take_rows`.
Not ported: the async packing and upload of the JAX data plane.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.data.containers import (
    Features,
    LabeledData,
    SparseFeatures,
    ell_has_duplicates,
)
from photon_ml_tpu_torch.data import device_assemble
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout, from_ell
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.types import ProjectorType

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RankMesh, RowSharding, RowView

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FixedEffectDataConfig:
    feature_shard: str


@dataclasses.dataclass(frozen=True)
class RandomEffectDataConfig:
    """active_upper_bound caps the rows per entity used for training (the
    rest are scored only); active_lower_bound drops entities with fewer rows
    from training; num_features_to_samples_ratio_upper_bound turns on the
    per-entity Pearson feature selection (at most ceil(ratio * rows)
    features an entity); min_bucket is the smallest padded block size;
    projector_type is the estimator's projection of the entities' features
    (projected_dim: RANDOM only); max_block_cells bounds entities x
    capacity per training block."""

    random_effect_type: str
    feature_shard: str
    active_upper_bound: Optional[int] = None
    active_lower_bound: Optional[int] = None
    num_features_to_samples_ratio_upper_bound: Optional[float] = None
    min_bucket: int = 8
    projector_type: ProjectorType = ProjectorType.INDEX_MAP
    projected_dim: Optional[int] = None
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
    # Every id tag factorized: tag -> (codes (N,) int64, sorted value table)
    # with table[codes] == id_tags[tag]; from ingest, or `factorize_tag`.
    # Ingest's table may hold values no sample uses.
    tag_codes: Dict[str, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=dict)
    # The stage times of the Avro read that made this dataset
    # (contracts.INGEST_TIMING_REQUIRED_KEYS); empty otherwise.
    ingest_timing: Dict[str, object] = dataclasses.field(default_factory=dict)

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
        tag_codes: Optional[Mapping[str, Tuple[np.ndarray, np.ndarray]]] = None,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = "cuda",
    ) -> "GameDataset":
        """From host arrays (numpy or tensors; a sparse shard is a
        `SparseFeatures`); everything is moved to `device` once here.
        `tag_codes` are factorized id tags (see the field); a tag without
        them is factorized here."""
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
        codes = dict(tag_codes or {})
        for k, (c, table) in codes.items():
            if k not in tags or len(c) != n:
                raise ValueError(f"tag codes {k!r} must factorize an id tag of {n} samples")
        for k, v in tags.items():
            if k not in codes:
                codes[k] = factorize_tag(v)
        return cls(feats, labels_t, off, wt, tags, tag_codes=codes)


def _pad_ell(x: SparseFeatures, k: int, keep_last: bool) -> Tuple[Tensor, Tensor]:
    """(N, K0) ELL planes widened to K columns of inert padding (index 0,
    value 0), inserted before the last column when `keep_last`."""
    idx, val = torch.as_tensor(x.indices), torch.as_tensor(x.values)
    pad = k - idx.shape[1]
    if pad == 0:
        return idx, val
    zi = idx.new_zeros((idx.shape[0], pad))
    zv = val.new_zeros((val.shape[0], pad))
    if keep_last:
        return (torch.cat([idx[:, :-1], zi, idx[:, -1:]], 1),
                torch.cat([val[:, :-1], zv, val[:, -1:]], 1))
    return torch.cat([idx, zi], 1), torch.cat([val, zv], 1)


def concat_datasets(*parts: GameDataset, keep_last: Sequence[str] = ()) -> GameDataset:
    """The rows of `parts` in order, as one dataset on the first part's
    device. Port of the JAX package's `concat_datasets`, for any
    number of parts: shard sets, feature dims and id tags must match; ELL
    planes widen to the widest K with inert padding, before the last column
    for the shards named in `keep_last` (a constant intercept column ingest
    appends at position K of every row); each id tag's value table is the
    union of the parts' tables, sorted, with every part's codes mapped into
    it. So files read one by one (each with the same index maps) and
    concatenated in order give one read of them all, bit for bit, when each
    part's intercept column is the appended one."""
    if not parts:
        raise ValueError("nothing to concatenate")
    first = parts[0]
    for b in parts[1:]:
        if set(b.shards) != set(first.shards):
            raise ValueError(f"cannot concat datasets with different shard sets "
                             f"{sorted(first.shards)} vs {sorted(b.shards)}")
        if set(b.tag_codes) != set(first.tag_codes):
            raise ValueError(f"cannot concat datasets with different id-tag columns "
                             f"{sorted(first.tag_codes)} vs {sorted(b.tag_codes)}")
    shards: Dict[str, object] = {}
    for name, fa in first.shards.items():
        feats = [p.shards[name] for p in parts]
        if any(isinstance(f, SparseFeatures) != isinstance(fa, SparseFeatures) for f in feats):
            raise ValueError(f"shard {name!r}: sparse/dense layouts differ")
        dims = {f.dim if isinstance(f, SparseFeatures) else int(f.shape[-1]) for f in feats}
        if len(dims) != 1:
            raise ValueError(f"shard {name!r}: dims differ ({sorted(dims)})")
        if isinstance(fa, SparseFeatures):
            k = max(int(f.indices.shape[1]) for f in feats)
            planes = [_pad_ell(f, k, name in keep_last) for f in feats]
            shards[name] = SparseFeatures(torch.cat([i.cpu() for i, _ in planes]),
                                          torch.cat([v.cpu() for _, v in planes]), fa.dim)
        else:
            shards[name] = torch.cat([torch.as_tensor(f).cpu() for f in feats])
    tag_codes = {}
    for tag in first.tag_codes:
        table = np.unique(np.concatenate([p.tag_codes[tag][1] for p in parts]))
        tag_codes[tag] = (np.concatenate([np.searchsorted(table, t)[c] for c, t in
                                          (p.tag_codes[tag] for p in parts)]).astype(np.int64),
                          table)
    column = lambda get: torch.cat([get(p).cpu() for p in parts])
    return GameDataset.build(
        shards, column(lambda p: p.labels), offsets=column(lambda p: p.offsets),
        weights=column(lambda p: p.weights),
        id_tags={tag: table[codes] for tag, (codes, table) in tag_codes.items()},
        tag_codes=tag_codes, dtype=first.labels.dtype, device=first.device)


def take_rows(dataset: GameDataset, rows) -> GameDataset:
    """The samples `rows` of `dataset`, in the order given, as a dataset on
    the same device (the JAX package's `take_rows`). Every plane is gathered
    on the device; each id tag and its factorized codes take the same rows,
    and each tag keeps its value table (values the subset no longer uses
    stay in it, as an ingest table may hold them)."""
    rows_np = np.asarray(rows, np.int64)
    idx = torch.as_tensor(rows_np).to(dataset.device)
    shards: Dict[str, object] = {}
    for name, feats in dataset.shards.items():
        if isinstance(feats, SparseFeatures):
            shards[name] = SparseFeatures(feats.indices[idx], feats.values[idx], feats.dim)
        else:
            shards[name] = feats[idx]
    return GameDataset.build(
        shards, dataset.labels[idx], offsets=dataset.offsets[idx], weights=dataset.weights[idx],
        id_tags={k: v[rows_np] for k, v in dataset.id_tags.items()},
        tag_codes={k: (c[rows_np], t) for k, (c, t) in dataset.tag_codes.items()},
        dtype=dataset.labels.dtype, device=dataset.device)


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


class EntityBlocks:
    """One padded bucket of entities with equal block capacity."""

    def __init__(self, gather: Tensor, mask: Tensor, entity_rows: Tensor):
        self.gather = gather  # (E, S) int64 sample rows
        self.mask = mask  # (E, S) float32
        self.entity_rows = entity_rows  # (E,) int64

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
    `feature_mask`: with Pearson feature selection, (E + 1, D) 0/1
    multipliers of each entity's features (in the projected slots once the
    estimator projects the shard; the unseen row is all ones), else None.
    `owned_entities`: on a rank, the entities (rows of the global matrix)
    it owns and trains, increasing; its coefficient store holds their rows
    alone, row i for `owned_entities[i]`, and the bucket and sample rows
    index that store (None: every entity, one process). The feature mask's
    rows are then store rows too.
    `view`: on a rank whose rows follow another random effect, the rows
    this one trains and scores (parallel/mesh.py `RowView`); the bucket
    gathers and `sample_entity_rows` index the view's rows. None: the
    dataset's own rows."""

    config: RandomEffectDataConfig
    entity_index: Dict[object, int]
    buckets: List[EntityBlocks]
    sample_entity_rows: Tensor  # (N,) int64
    num_active_samples: int
    num_passive_samples: int
    feature_mask: Optional[Tensor] = None
    owned_entities: Optional[Tensor] = None
    view: Optional["RowView"] = None

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
    """The entity-blocked layout of one id tag, on the device it was built on.

    `codes` is each sample's entity code (its coefficient row); `blocks`
    holds one (gather (E, S), mask (E, S), entity_rows (E,)) triple per
    padded bucket chunk, gathers indexing the sample axis the layout was
    built from; `active_rows` are the active rows in (entity, row) order,
    `kept` the entity codes that keep any, and `a_starts` their segments."""

    entity_index: Dict[object, int]
    codes: Tensor
    blocks: List[Tuple[Tensor, Tensor, Tensor]]
    num_active: int
    active_rows: Tensor
    kept: np.ndarray
    a_starts: np.ndarray

    @property
    def num_entities(self) -> int:
        return len(self.entity_index)


def factorize_tag(values) -> Tuple[np.ndarray, np.ndarray]:
    """(codes (N,) int64, sorted value table) of one id tag."""
    table, codes = np.unique(np.asarray(values), return_inverse=True)
    return codes.reshape(-1).astype(np.int64), table


def entity_layout(
    tag_codes: Tuple[np.ndarray, np.ndarray],
    config: RandomEffectDataConfig,
    device: torch.device,
) -> EntityLayout:
    """The entity-blocked layout from an id tag's factorized form (codes
    into a sorted value table): the entities are the table's values that
    some sample uses, in the table's (sorted) order. The sample-sized work
    (sort, rank, scatter) runs as torch ops on `device`
    (data/device_assemble.py); the entity-sized planning runs on the host."""
    raw_codes, table = tag_codes
    raw = torch.as_tensor(raw_codes).to(device)
    used = (torch.bincount(raw, minlength=len(table)) > 0).cpu().numpy()
    uniq = table[used]
    codes = torch.as_tensor(np.cumsum(used) - 1).to(device)[raw]
    num_entities = len(uniq)
    counts = torch.bincount(codes, minlength=num_entities).cpu().numpy()
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
    kept = np.nonzero(a_counts > 0)[0]
    assembler = device_assemble.BlockAssembler(codes, counts, a_counts, kept, need_reservoir)

    # Bucket by padded capacity: the power of two (times min_bucket) >= size.
    min_b = max(config.min_bucket, 1)
    pows = min_b * (1 << np.arange(0, 40, dtype=np.int64))
    pows = pows[pows < (1 << 40)]
    cap_of_kept = pows[np.searchsorted(pows, a_counts[kept])]

    blocks: List[Tuple[Tensor, Tensor, Tensor]] = []
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
        gather, mask = assembler.bucket_blocks(local, e + pad_e, int(capacity))
        ent_rows = torch.as_tensor(np.concatenate([ent_rows, np.full(pad_e, num_entities, np.int64)])).to(device)
        for c in range(n_chunks):
            sl = slice(c * target, (c + 1) * target)
            blocks.append((gather[sl], mask[sl], ent_rows[sl]))
    return EntityLayout(entity_index, codes, blocks, int(a_counts.sum()), assembler.active, kept,
                        assembler.a_starts)


def build_random_effect_dataset(
    dataset: GameDataset, config: RandomEffectDataConfig, times: Optional[StageTimes] = None
) -> RandomEffectDataset:
    """One-time construction of the entity-blocked layout on the dataset's
    device, or, for a dataset sharded over ranks, this rank's part of the
    layout built from the global id tag (parallel/mesh.py; a collective, so
    every rank builds it). `times`, when given, gets the build's seconds as
    `re_build`, the assembly's as `re_device` (each stops once the device
    has finished) and `re_path`."""
    tag = config.random_effect_type
    if tag not in dataset.id_tags:
        raise ValueError(f"id tag {tag!r} not present in dataset")
    feats = dataset.shards[config.feature_shard]
    if dataset.sharding is not None:
        # Every rank checks its own rows, and every rank raises if one finds any.
        if isinstance(feats, SparseFeatures) and not dataset.mesh.all_true(
                not ell_has_duplicates(feats.indices, feats.values)):
            _refuse_duplicates(config)
        return dataset.sharding.random_effect_dataset(dataset, config)
    times = StageTimes() if times is None else times
    dev = dataset.device
    with times.stage("re_build", dev):
        if isinstance(feats, SparseFeatures) and ell_has_duplicates(feats.indices, feats.values):
            _refuse_duplicates(config)
        with times.stage("re_device", dev):
            layout = entity_layout(dataset.tag_codes[tag], config, dev)
        times.note("re_path", "device")
        feature_mask = None
        if config.num_features_to_samples_ratio_upper_bound is not None:
            active_lists = np.split(layout.active_rows.cpu().numpy(), layout.a_starts[1:-1])
            feature_mask = torch.as_tensor(pearson_feature_masks(
                dataset, config, active_lists, list(layout.kept), layout.num_entities)).to(dev)
        return RandomEffectDataset(
            config=config,
            entity_index=layout.entity_index,
            buckets=[EntityBlocks(g, m, e) for g, m, e in layout.blocks],
            sample_entity_rows=layout.codes,
            num_active_samples=layout.num_active,
            num_passive_samples=dataset.num_samples - layout.num_active,
            feature_mask=feature_mask,
        )


def _refuse_duplicates(config: RandomEffectDataConfig) -> None:
    # The coordinate's dense blocks are exact only for distinct features.
    raise ValueError(f"shard {config.feature_shard!r} names a feature twice within a row; "
                     "merge duplicate entries first (pack_csr_to_ell)")


def pearson_feature_masks(
    dataset: GameDataset,
    config: RandomEffectDataConfig,
    active_lists: List[np.ndarray],
    kept_entities: List[int],
    num_entities: int,
) -> np.ndarray:
    """Per-entity 0/1 feature masks by |Pearson corr(feature, label)|, on
    the host, as the reference computes them (its `_pearson_feature_masks`,
    line for line: only the same numpy calls, `np.argpartition` among them,
    pick the same features when |corr| ties). Keep ceil(ratio * n_rows)
    features an entity, ranked by |Pearson|; a constant-one column (the
    intercept) scores 1.0, so it is always kept. `active_lists[i]` are the
    rows of `dataset` that mask row `kept_entities[i]` trains on; the
    other rows, row `num_entities` (the unseen entity) among them, keep
    every feature."""
    ratio = config.num_features_to_samples_ratio_upper_bound
    features = dataset.shards[config.feature_shard]
    labels_np = dataset.labels.cpu().numpy()
    if isinstance(features, SparseFeatures):
        # Moments straight from the ELL entries: absent entries are zeros.
        dim = features.dim
        ell_idx = features.indices.cpu().numpy()
        ell_val = features.values.cpu().numpy().astype(np.float64)

        def entity_corr(rows: np.ndarray, y: np.ndarray) -> np.ndarray:
            n_rows = len(rows)
            idx = ell_idx[rows].ravel()
            val = ell_val[rows]
            # Padding entries are (index 0, value 0): inert in the value sums;
            # the nnz count masks them out of presence-based terms.
            present = (val != 0).ravel().astype(np.float64)
            sum_x = np.bincount(idx, weights=val.ravel(), minlength=dim)
            cnt = np.bincount(idx, weights=present, minlength=dim)
            mean_x = sum_x / n_rows
            # Centered (two-pass) moments:
            #   x_ss = sum_nz (x - mx)^2 + (n - nnz) * mx^2
            #   cov  = sum_nz (x - mx) yc + mx * sum_nz yc
            yc = y - y.mean()
            y_ss = float(yc @ yc)
            dev = (val.ravel() - mean_x[idx]) * present
            x_ss = np.bincount(idx, weights=dev * dev, minlength=dim)
            x_ss = x_ss + (n_rows - cnt) * mean_x * mean_x
            ycb = np.broadcast_to(yc[:, None], val.shape).ravel()
            cov = np.bincount(
                idx, weights=dev * ycb, minlength=dim
            ) + mean_x * np.bincount(idx, weights=ycb * present, minlength=dim)
            denom = np.sqrt(x_ss * y_ss)
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = np.where(denom > 0, np.abs(cov) / np.where(denom > 0, denom, 1.0), 0.0)
            # Intercept: constant-one column (value 1 in every row) scores 1.0.
            is_ones = (cnt == n_rows) & (sum_x == n_rows)
            return np.where(is_ones & (x_ss <= 1e-9 * n_rows), 1.0, corr)

    else:
        feats_np = features.cpu().numpy()
        dim = feats_np.shape[-1]

        def entity_corr(rows: np.ndarray, y: np.ndarray) -> np.ndarray:
            X = feats_np[rows].astype(np.float64)
            Xc = X - X.mean(axis=0)
            yc = y - y.mean()
            x_std = np.sqrt((Xc * Xc).sum(axis=0))
            y_std = np.sqrt((yc * yc).sum())
            denom = x_std * y_std
            with np.errstate(invalid="ignore", divide="ignore"):
                corr = np.where(
                    denom > 0, np.abs(Xc.T @ yc) / np.where(denom > 0, denom, 1.0), 0.0
                )
            # Intercept: constant-one column scores 1.0 (always kept).
            return np.where(
                (x_std == 0) & (X[0] == 1.0) & (np.ptp(X, axis=0) == 0), 1.0, corr
            )

    masks = np.ones((num_entities + 1, dim), np.float32)
    for rows, row_id in zip(active_lists, kept_entities):
        n_rows = len(rows)
        keep = int(np.ceil(ratio * n_rows))
        if keep >= dim:
            continue
        corr = entity_corr(rows, labels_np[rows].astype(np.float64))
        keep_idx = np.argpartition(corr, -keep)[-keep:]
        row_mask = np.zeros(dim, np.float32)
        row_mask[keep_idx] = 1.0
        masks[row_id] = row_mask
    return masks


def gather_block_data(
    dataset: GameDataset,
    shard: str,
    blocks: EntityBlocks,
    offsets: Optional[Tensor] = None,
    feature_mask: Optional[Tensor] = None,
) -> LabeledData:
    """The (E, S, ...) LabeledData of one bucket; padding slots get weight
    0. A dense shard gives (E, S, D) features, a sparse one an (E, S, K) ELL
    block (`SparseFeatures` with batch axes). Offsets default to the
    dataset's; coordinate descent passes the residual-adjusted ones.
    `feature_mask` is the random effect's (E_total + 1, D) Pearson
    selection: each lane's row multiplies its features, so deselected
    features carry no signal (and, from a zero start under L2, keep a zero
    coefficient)."""
    offs = dataset.offsets if offsets is None else offsets
    g = blocks.gather
    feats = dataset.shards[shard]
    block_mask = None if feature_mask is None else feature_mask[blocks.entity_rows]  # (E, D)
    if isinstance(feats, SparseFeatures):
        idx, val = feats.indices[g], feats.values[g]
        if block_mask is not None:
            val = val * torch.gather(block_mask, 1, idx.long().flatten(1)).view_as(val)
        feats = SparseFeatures(idx, val, feats.dim)
    else:
        feats = feats[g]
        if block_mask is not None:
            feats = feats * block_mask[:, None, :]
    return LabeledData(
        features=feats,
        labels=dataset.labels[g],
        offsets=offs[g],
        weights=dataset.weights[g] * blocks.mask,
    )
