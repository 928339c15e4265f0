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
(`ell_axis=-1`).
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
) -> SparseFeatures:
    """Host CSR -> padded ELL, as CPU tensors (indices int32, values `dtype`).

    Duplicate (row, col) pairs are summed in float64, in CSR order; the ELL
    width K stays the longest row before that merge (at least 1). Padding
    entries have index 0 and value 0. As in the JAX package, every row comes
    out column-sorted when any pair repeats, and keeps its CSR order when
    none does."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    values = np.asarray(values)
    n = len(indptr) - 1
    row_lens = np.diff(indptr)
    k = max(int(row_lens.max()) if n else 0, 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), row_lens)
    if len(indices) and (indices.min() < 0 or indices.max() >= dim):
        raise ValueError(f"CSR column indices must lie in [0, {dim})")
    key = rows * np.int64(dim) + indices
    order = np.argsort(key, kind="stable")
    sk = key[order]
    if len(sk) and (sk[1:] == sk[:-1]).any():
        first = np.ones(len(sk), bool)
        first[1:] = sk[1:] != sk[:-1]
        starts = np.nonzero(first)[0]
        values = np.add.reduceat(values.astype(np.float64)[order], starts)
        ukey = sk[starts]
        rows, indices = ukey // np.int64(dim), ukey % np.int64(dim)
        row_lens = np.bincount(rows, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(row_lens, out=indptr[1:])
    out_idx = np.zeros((n, k), np.int32)
    out_val = np.zeros((n, k), dtype)
    pos = np.arange(len(rows), dtype=np.int64) - np.repeat(indptr[:-1], row_lens)
    out_idx[rows, pos] = indices
    out_val[rows, pos] = values
    return SparseFeatures(torch.from_numpy(out_idx), torch.from_numpy(out_val), int(dim))
