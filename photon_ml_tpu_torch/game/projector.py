"""Random-effect feature-space projectors.

Port of `photon_ml_tpu/game/projector.py`. A random effect's coefficients
are one (E + 1, D_proj) matrix, so every entity shares one projected width:

  * IndexMapProjector (the estimator's default): per-entity index
    compaction. Entity e's distinct features (over all its rows) take local
    slots 0..k_e-1 in increasing order; D_proj = max_e k_e rounded up to a
    multiple of 8, as in the reference, so slot tables and models have its
    shapes. Projection rewrites a shard's ELL indices to local slots once
    (data/device_assemble.py, on the shard's device); the projected shard
    stays in the port's (N, K) orientation with int32 indices.
    Back-projection scatters each row through its entity's slot table.
  * RandomProjector: one Gaussian matrix P (D, d) with N(0, 1/d) entries,
    drawn on the CPU from a `torch.Generator` seeded by the estimator's
    seed and then moved, so the card and the CPU hold the same P. Sparse
    features are densified through it (X P); w_orig = P w_proj.
  * IdentityProjector: no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from photon_ml_tpu_torch.data import device_assemble
from photon_ml_tpu_torch.data.containers import Features, SparseFeatures
from photon_ml_tpu_torch.data.stats import FeatureDataStatistics, sparse_summary_arrays
from photon_ml_tpu_torch.types import ProjectorType

Tensor = torch.Tensor


class IdentityProjector:
    def __init__(self, dim: int):
        self.original_dim = dim
        self.projected_dim = dim

    def project_features(self, features: Features, entity_rows: Tensor) -> Features:
        return features

    def back_project_matrix(self, matrix: Tensor) -> Tensor:
        return matrix

    def project_matrix(self, matrix: Tensor) -> Tensor:
        return matrix


class IndexMapProjector:
    """`slot_tables[e, j]`: the global feature in local slot j of entity e
    (-1: padding); row E, the unseen entities' row, is empty."""

    def __init__(self, slot_tables: Tensor, original_dim: int):
        self.slot_tables = slot_tables  # (E + 1, D_proj) int64
        self.original_dim = int(original_dim)
        self.projected_dim = int(slot_tables.shape[1])
        self._keys, self._offsets = device_assemble.table_keys(slot_tables, self.original_dim)
        # The original shard's summary, when `build` was asked for it: one
        # pass over the planes it already holds feeds the normalization.
        self.original_stats: Optional[FeatureDataStatistics] = None

    @classmethod
    def build(cls, features: SparseFeatures, entity_rows: Tensor, num_entities: int, *,
              want_stats: bool = False) -> "IndexMapProjector":
        """From every sample's entries (active and passive rows alike)."""
        tables = device_assemble.build_index_tables(
            features.indices, features.values, entity_rows, num_entities, features.dim)
        proj = cls(tables, features.dim)
        if want_stats:
            proj.original_stats = sparse_summary_arrays(features.indices, features.values, features.dim)
        return proj

    def project_features(self, features: SparseFeatures, entity_rows: Tensor) -> SparseFeatures:
        """The shard's entries at their entities' local slots; entries of a
        feature the entity's table lacks (padding, unseen entities) become
        (slot 0, 0.0)."""
        dev = features.values.device
        out, val = device_assemble.project_entries(
            self._keys.to(dev), self._offsets.to(dev), self.original_dim, features.indices,
            features.values, entity_rows.to(dev))
        return SparseFeatures(out, val, self.projected_dim)

    def back_project_matrix(self, matrix: Tensor) -> Tensor:
        """(E + 1, D_proj) -> (E + 1, D): each row scattered through its
        slot table (padding slots land in a dropped extra column)."""
        tables = self.slot_tables.to(matrix.device)
        cols = torch.where(tables >= 0, tables, torch.full_like(tables, self.original_dim))
        out = torch.zeros((matrix.shape[0], self.original_dim + 1), dtype=matrix.dtype, device=matrix.device)
        return out.scatter_add_(1, cols, matrix)[:, : self.original_dim]

    def project_matrix(self, matrix: Tensor) -> Tensor:
        """(E + 1, D) original-space rows -> (E + 1, D_proj): each entity's
        slots gathered, padding slots 0 (the inverse of back_project_matrix
        on this projector's support)."""
        tables = self.slot_tables.to(matrix.device)
        out = torch.gather(matrix, 1, tables.clamp_min(0))
        return out.masked_fill(tables < 0, 0.0)

    def entity_coefficients(self, matrix: Tensor, entity_row: int) -> Dict[int, float]:
        """One entity's model as {global feature: weight}, nonzero weights only."""
        row = matrix[entity_row].tolist()
        table = self.slot_tables[entity_row].tolist()
        return {int(g): float(w) for g, w in zip(table, row) if g >= 0 and w != 0.0}


class RandomProjector:
    def __init__(self, matrix: Tensor):
        self.matrix = matrix  # (D, d_proj)
        self.original_dim = int(matrix.shape[0])
        self.projected_dim = int(matrix.shape[1])

    @classmethod
    def build(cls, original_dim: int, projected_dim: int, seed: int = 0, *,
              device: torch.device) -> "RandomProjector":
        gen = torch.Generator().manual_seed(seed)
        p = torch.randn((original_dim, projected_dim), generator=gen) / torch.sqrt(
            torch.tensor(float(projected_dim)))
        return cls(p.to(device))

    def project_features(self, features: Features, entity_rows: Tensor) -> Tensor:
        """Dense (N, d) projected features: X P."""
        if isinstance(features, SparseFeatures):
            rows = self.matrix[features.indices.long()]  # (N, K, d)
            return torch.einsum("nk,nkd->nd", features.values, rows)
        return features @ self.matrix

    def back_project_matrix(self, matrix: Tensor) -> Tensor:
        """w_orig = P w_proj for every entity row."""
        return matrix @ self.matrix.T

    def project_matrix(self, matrix: Tensor) -> Tensor:
        """Original-space rows -> projected rows by least squares through P,
        w_proj = (P^T P)^-1 P^T w_orig (a warm start, not an inverse)."""
        p = self.matrix
        return torch.linalg.solve(p.T @ p, p.T @ matrix.T).T


def build_projector(projector_type: ProjectorType, features: Features, entity_rows: Tensor,
                    num_entities: int, *, projected_dim: Optional[int] = None, seed: int = 0,
                    want_stats: bool = False):
    """A random effect's projector; INDEX_MAP on a dense shard is the identity
    (nothing to compact)."""
    dim = features.dim if isinstance(features, SparseFeatures) else int(features.shape[-1])
    if projector_type == ProjectorType.IDENTITY:
        return IdentityProjector(dim)
    if projector_type == ProjectorType.RANDOM:
        if projected_dim is None:
            raise ValueError("RANDOM projector requires projected_dim")
        return RandomProjector.build(dim, projected_dim, seed, device=entity_rows.device)
    if projector_type == ProjectorType.INDEX_MAP:
        if not isinstance(features, SparseFeatures):
            return IdentityProjector(dim)
        return IndexMapProjector.build(features, entity_rows, num_entities, want_stats=want_stats)
    raise ValueError(f"unknown projector type {projector_type}")


@dataclasses.dataclass
class ProjectedShard:
    shard_name: str
    projector: object  # IdentityProjector | IndexMapProjector | RandomProjector


def project_shard(dataset, re_dataset, projector_type: ProjectorType, *,
                  projected_dim: Optional[int] = None, seed: int = 0,
                  want_stats: bool = False) -> ProjectedShard:
    """Register the projected view of `re_dataset`'s shard on the dataset as
    '<shard>@<re_type>' (then '#2', '#3', ... if taken) and repoint the
    random-effect dataset at it: its blocks are per sample and stay as they
    are, and a Pearson mask moves into the projected slots."""
    shard = re_dataset.feature_shard
    feats = dataset.shards[shard]
    rows = re_dataset.sample_entity_rows
    projector = build_projector(projector_type, feats, rows, re_dataset.num_entities,
                                projected_dim=projected_dim, seed=seed, want_stats=want_stats)
    if isinstance(projector, IdentityProjector):
        return ProjectedShard(shard, projector)
    if re_dataset.feature_mask is not None:
        if not isinstance(projector, IndexMapProjector):
            raise ValueError("Pearson feature selection needs an INDEX_MAP or IDENTITY projector")
        re_dataset.feature_mask = projector.project_matrix(re_dataset.feature_mask)
    re_type = re_dataset.config.random_effect_type
    name = f"{shard}@{re_type}"
    suffix = 2
    while name in dataset.shards:
        name = f"{shard}@{re_type}#{suffix}"
        suffix += 1
    dataset.shards[name] = projector.project_features(feats, rows)
    re_dataset.config = dataclasses.replace(re_dataset.config, feature_shard=name)
    return ProjectedShard(name, projector)
