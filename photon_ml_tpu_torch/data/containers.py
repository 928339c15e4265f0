"""Columnar labeled data on a device.

Port of `photon_ml_tpu/data/containers.py`: a batch of N labeled points is
a struct of tensors, the design matrix plus the (N,) labels, offsets and
weights. Weight 0 marks a padding row, so every weighted reduction is
mask-correct. Dense features are an (N, D) tensor, and leading batch axes
are allowed: a random-effect bucket is one LabeledData of (E, S, D)
features and (E, S) vectors.

Sparse features are `SparseFeatures`, the padded ELL layout (N, K): row r
holds features indices[r, k] with values values[r, k]; padding entries have
value 0 and index 0. It is how a sparse shard is handed in and stored; the
objective on the card runs on the sparse layout built from it
(data/sparse_layout.py). Only the standard (N, K) plane layout is ported
(`ell_axis=-1`). A random-effect bucket of a sparse shard is an (E, S, K)
block of the same planes, which `ell_block_to_dense` makes dense for the
batched solve.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple, Union

import numpy as np
import torch

from photon_ml_tpu_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from photon_ml_tpu_torch.parallel.mesh import RankMesh

Tensor = torch.Tensor


def _plain_only(t: Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise RuntimeError(
            f"SparseFeatures.{what} is the plain CPU version; on {t.device} build the "
            "layout (data/sparse_layout.from_ell) and use ops/sparse_kernels"
        )


@dataclasses.dataclass(frozen=True)
class SparseFeatures:
    """Padded ELL sparse matrix: row r has features indices[r, k] -> values[r, k].

    Duplicate indices within a row are summed by every consumer (they are
    linear in the entries), so hand-built planes may carry them; the
    squared product `sq_rmatvec` squares each entry as stored. The
    products here are the plain versions (gather, and `index_add_` for the
    transposes) and run on CPU tensors only."""

    indices: Tensor  # (N, K) int32 or int64
    values: Tensor  # (N, K) float32
    dim: int
    # Set on the projected shard that game/projector.project_shard
    # registers: the reference keeps such a shard's planes as (K, N), and
    # the checkpoint fingerprint names its shape in that orientation.
    projected: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self.values.shape[0]), int(self.dim))

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, w: Tensor) -> Tensor:
        """x_r . w for every row: gather w at the indices, multiply, reduce."""
        _plain_only(self.values, "matvec")
        return torch.sum(w[self.indices.long()] * self.values.to(w.dtype), dim=-1)

    def rmatvec(self, u: Tensor) -> Tensor:
        """X^T u by scatter-add (the transpose of `matvec`)."""
        _plain_only(self.values, "rmatvec")
        return self._scatter(self.values.to(u.dtype) * u[:, None])

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        """sum_r u_r x_r^2 per feature (Hessian diagonals)."""
        _plain_only(self.values, "sq_rmatvec")
        v = self.values.to(u.dtype)
        return self._scatter(v * v * u[:, None])

    def _scatter(self, per_entry: Tensor) -> Tensor:
        out = torch.zeros(self.dim, dtype=per_entry.dtype, device=per_entry.device)
        return out.index_add_(0, self.indices.reshape(-1).long(), per_entry.reshape(-1))


Features = Union[Tensor, SparseFeatures]

# The largest dense block `ell_block_to_dense` builds, in bytes. A random-
# effect chunk holds at most max_block_cells = 2^21 (entity, row) cells, so
# at D = 201 its block is 2^21 x 201 x 4 B = 1.57 GiB; a wider shard needs
# the projector (not ported yet), which maps each entity onto its own
# features.
MAX_DENSE_BLOCK_BYTES = 1 << 31


def ell_has_duplicates(indices: Tensor, values: Tensor) -> bool:
    """Does any row of ELL planes (..., K) name one feature twice among its
    nonzero entries? (Padding and explicit zeros do not count.)"""
    k = indices.shape[-1]
    sentinel = -1 - torch.arange(k, device=indices.device)  # distinct per position
    keyed = torch.where(values != 0, indices.long(), sentinel)
    ordered = torch.sort(keyed, dim=-1).values
    return bool((ordered[..., 1:] == ordered[..., :-1]).any())


def ell_block_to_dense(block: SparseFeatures) -> Tensor:
    """An ELL block (..., S, K) as the dense (..., S, D) matrix it stands
    for, on its device.

    The entries are added into zeros with `scatter_add_`, padding and zeros
    as +0.0. The planes must not name a feature twice within a row among
    their nonzero entries (planes from ingest and from `pack_csr_to_ell`
    never do; `build_random_effect_dataset` checks a sparse shard once with
    `ell_has_duplicates`). Then every cell receives at most one nonzero
    addend and any number of exact zeros, so the result is exact and the
    same bits on every run, whatever order the device adds in. A block
    above MAX_DENSE_BLOCK_BYTES is refused."""
    idx, val = block.indices, block.values
    lead = tuple(val.shape[:-1])
    nbytes = val[..., 0].numel() * block.dim * val.element_size()
    if nbytes > MAX_DENSE_BLOCK_BYTES:
        raise ValueError(
            f"a dense block of {lead} x {block.dim} would take {nbytes} bytes, above "
            f"MAX_DENSE_BLOCK_BYTES ({MAX_DENSE_BLOCK_BYTES}); lower max_block_cells")
    dense = torch.zeros((*lead, block.dim), dtype=val.dtype, device=val.device)
    entries = torch.where(val != 0, val, torch.zeros((), dtype=val.dtype, device=val.device))
    return dense.scatter_add_(-1, idx.long(), entries)


@dataclasses.dataclass(frozen=True)
class LabeledData:
    features: "Features"  # (..., N, D) float32/bfloat16, SparseFeatures or SparseLayout
    labels: Tensor  # (..., N)
    offsets: Tensor  # (..., N)
    weights: Tensor  # (..., N)
    # Set when the rows are one rank's share: every sum over rows in
    # ops/objective.py then crosses the ranks.
    mesh: Optional["RankMesh"] = None


def dense_data(
    X,
    y,
    *,
    offsets=None,
    weights=None,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = "cuda",
) -> LabeledData:
    """LabeledData from host arrays (numpy or tensors)."""
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype).to(dev)
    y_t = as_t(y)
    n = y_t.shape[0]
    off = torch.zeros(n, dtype=dtype, device=dev) if offsets is None else as_t(offsets)
    wt = torch.ones(n, dtype=dtype, device=dev) if weights is None else as_t(weights)
    return LabeledData(as_t(X).contiguous(), y_t, off, wt)


def optional_tensor(a, device: torch.device) -> Optional[Tensor]:
    return None if a is None else torch.tensor(np.asarray(a), device=device)


def pack_csr_to_ell(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray,
    dim: int,
    *,
    dtype=np.float32,
    assume_clean: bool = False,
    extra_col: Optional[Tuple[int, float]] = None,
) -> SparseFeatures:
    """Host CSR -> padded ELL, as CPU tensors (indices int32, values `dtype`).

    The JAX package's semantics (`photon_ml_tpu/data/containers.py:166`):
    duplicate (row, col) pairs are summed in float64, in CSR order, unless
    `assume_clean` says there are none (the native decoder merges a record's
    repeated keys itself); the ELL width K is the longest row before that
    merge (at least 1). Every row comes out column-sorted when any pair
    repeats, and keeps its CSR order when none does. `extra_col=(index,
    value)` appends one constant column at position K of every row (the
    intercept). Padding entries have index 0 and value 0."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    values = np.asarray(values)
    n = len(indptr) - 1
    row_lens = np.diff(indptr)
    k = max(int(row_lens.max()) if n else 0, 1)
    if len(indices) and (indices.min() < 0 or indices.max() >= dim):
        raise ValueError(f"CSR column indices must lie in [0, {dim})")
    extra = 0 if extra_col is None else 1
    out_idx = np.zeros((n, k + extra), np.int32)
    out_val = np.zeros((n, k + extra), dtype)
    if extra_col is not None:
        out_idx[:, k] = extra_col[0]
        out_val[:, k] = extra_col[1]
    rows = np.repeat(np.arange(n, dtype=np.int64), row_lens)
    if not assume_clean and len(indices):
        key = rows * np.int64(dim) + indices.astype(np.int64)
        order = np.argsort(key, kind="stable")
        sk = key[order]
        if (sk[1:] == sk[:-1]).any():
            first = np.ones(len(sk), bool)
            first[1:] = sk[1:] != sk[:-1]
            starts = np.nonzero(first)[0]
            values = np.add.reduceat(values.astype(np.float64)[order], starts).astype(values.dtype)
            ukey = sk[starts]
            rows, indices = ukey // np.int64(dim), ukey % np.int64(dim)
            row_lens = np.bincount(rows, minlength=n)
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(row_lens, out=indptr[1:])
    pos = np.arange(len(rows), dtype=np.int64) - np.repeat(indptr[:-1], row_lens)
    out_idx[rows, pos] = indices
    out_val[rows, pos] = values
    return SparseFeatures(torch.from_numpy(out_idx), torch.from_numpy(out_val), int(dim))
