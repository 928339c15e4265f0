"""Device layout of a sparse fixed-effect shard: CSR forward, CSC backward.

Counterpart of `photon_ml_tpu/data/bucketed.py` (the two-level bucketed
layout) and `photon_ml_tpu/data/device_pack.py` (its device-side pack).
That layout exists to suit the TPU's 128-lane `dynamic_gather`
(bucketed.py:11-26); the kernels' contract is on z, g and the objective
value, not on the layout, so the port keeps the entries in the two orders
its CUDA kernels (csrc/sparse_glm.cu) read:

  * CSR, row-major, for the forward pass (z = X w): a warp per row sums
    the row's entries in a fixed order;
  * CSC, column-major, for the backward pass (g = X^T u): the column's
    entries are cut into chunks of at most CHUNK entries that never
    straddle a column, a warp per chunk, and the chunks of a column are
    added in order. A hot column is many chunks, so it does not stall one
    warp.

Both orders give fixed-order reductions without float atomics. The layout
is built once per shard on the shard's device with torch ops (a stable sort,
`bincount`, `cumsum`): padding and other zero entries are dropped (an ELL
pad would otherwise land on column 0 and make it a hot column), duplicate
(row, col) pairs are summed in their stored order, and offsets are int64.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures

Tensor = torch.Tensor

# CSC entries per backward work item (one warp each).
CHUNK = 512


@dataclasses.dataclass(frozen=True)
class SparseLayout:
    """Every nonzero entry of an (n_rows, dim) matrix, once in CSR and once
    in CSC, plus the CSC chunk table. Index planes are int32, offsets int64."""

    n_rows: int
    dim: int
    row_ptr: Tensor  # (n_rows + 1,) int64
    col_idx: Tensor  # (nnz,) int32, CSR order
    row_val: Tensor  # (nnz,) float32, CSR order
    col_ptr: Tensor  # (dim + 1,) int64
    row_idx: Tensor  # (nnz,) int32, CSC order
    col_val: Tensor  # (nnz,) float32, CSC order
    chunk_ptr: Tensor  # (dim + 1,) int64: column c's chunks are chunk_ptr[c]..chunk_ptr[c+1]
    chunk_start: Tensor  # (n_chunks + 1,) int64: chunk k is CSC entries [chunk_start[k], chunk_start[k+1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.dim)

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_start.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.row_val.device


def _ptr(counts: Tensor) -> Tensor:
    ptr = torch.zeros(counts.shape[0] + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(counts, 0, out=ptr[1:])
    return ptr


def _merge_duplicates(key: Tensor, vals: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum the values of equal consecutive keys, in their order."""
    ukey, counts = torch.unique_consecutive(key, return_counts=True)
    if ukey.shape[0] == key.shape[0]:
        return key, vals
    starts = torch.cumsum(counts, 0) - counts
    merged = vals[starts]
    for j in range(1, int(counts.max())):
        more = counts > j
        merged[more] = merged[more] + vals[starts[more] + j]
    return ukey, merged


def from_coo(rows: Tensor, cols: Tensor, vals: Tensor, n_rows: int, dim: int) -> SparseLayout:
    """The layout of the COO triplets, built on their device."""
    if not (rows.shape == cols.shape == vals.shape and vals.ndim == 1):
        raise ValueError("rows, cols and vals must be 1-D of one length")
    if vals.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {vals.dtype}")
    rows, cols = rows.long(), cols.long()
    keep = vals != 0
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if rows.numel():
        lo = torch.stack([rows.min(), cols.min()]).tolist()
        hi = torch.stack([rows.max(), cols.max()]).tolist()
        if lo[0] < 0 or hi[0] >= n_rows or lo[1] < 0 or hi[1] >= dim:
            raise ValueError(f"entries must lie in [0, {n_rows}) x [0, {dim})")
    key, order = torch.sort(rows * dim + cols, stable=True)
    key, vals = _merge_duplicates(key, vals[order])
    rows, cols = key // dim, key % dim
    row_ptr = _ptr(torch.bincount(rows, minlength=n_rows))
    # A stable sort by column keeps the rows of each column ascending.
    corder = torch.sort(cols, stable=True).indices
    col_counts = torch.bincount(cols, minlength=dim)
    col_ptr = _ptr(col_counts)
    n_per_col = (col_counts + CHUNK - 1) // CHUNK
    chunk_ptr = _ptr(n_per_col)
    chunk_col = torch.repeat_interleave(torch.arange(dim, device=key.device), n_per_col)
    within = torch.arange(chunk_col.shape[0], device=key.device) - chunk_ptr[chunk_col]
    chunk_start = torch.cat([col_ptr[chunk_col] + within * CHUNK, col_ptr[-1:]])
    return SparseLayout(
        n_rows=int(n_rows), dim=int(dim),
        row_ptr=row_ptr, col_idx=cols.int(), row_val=vals,
        col_ptr=col_ptr, row_idx=rows[corder].int(), col_val=vals[corder],
        chunk_ptr=chunk_ptr, chunk_start=chunk_start,
    )


def from_ell(features: SparseFeatures) -> SparseLayout:
    """The layout of a 2-D ELL matrix, built on its device."""
    if features.indices.ndim != 2 or features.indices.shape != features.values.shape:
        raise ValueError("from_ell takes (N, K) ELL planes of one shape")
    n, k = features.indices.shape
    rows = torch.arange(n, device=features.device).repeat_interleave(k)
    return from_coo(rows, features.indices.reshape(-1), features.values.reshape(-1),
                    n, features.dim)
