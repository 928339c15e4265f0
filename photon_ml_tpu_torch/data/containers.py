"""Columnar labeled data on a device.

Port of `photon_ml_tpu/data/containers.py`: a batch of N labeled points is
a struct of tensors, the design matrix plus the (N,) labels, offsets and
weights. Weight 0 marks a padding row, so every weighted reduction is
mask-correct. Dense features are an (N, D) tensor, and leading batch axes
are allowed: a random-effect bucket is one LabeledData of (E, S, D)
features and (E, S) vectors.

Sparse features are `SparseFeatures`, the padded ELL layout (N, K): row r
holds features indices[r, k] with values values[r, k]; padding entries have
value 0 and index 0. It is how a sparse shard is handed in and stored; a
fixed effect's objective on the card runs on the sparse layout built from
it (data/sparse_layout.py). Only the standard (N, K) plane layout is ported
(`ell_axis=-1`). A random-effect bucket of a sparse shard is an (E, S, K)
block of the same planes, one lane an entity, and its solve runs on that
block as the reference's does, lane by lane: X w is a gather and a sum over
K on any device; X^T u and (X o X)^T u are ops/ell_kernels.py's kernel on
the card, over the block's transpose plan (`ell_transpose_plan`, built once
per block), and its plain version on the CPU. The block is made dense
(`ell_block_to_dense`) only where the reference densifies it: FULL
variances' Hessians, a chunk of lanes at a time.
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

    Planes (N, K) are a shard: their products here are the plain versions
    (gather, and `index_add_` for the transposes) and run on CPU tensors
    only; on the card a shard's products run on its sparse layout. Planes
    (E, S, K) are a random-effect block, E problems of S rows: `matvec`
    takes w (E, D) and runs on any device (a gather and a sum over K), and
    the transposes give (E, D), by ops/ell_kernels.py (the kernel over
    `plan` on the card, the plain version on the CPU).

    Duplicate indices within a row are summed by every product (they are
    linear in the entries), as in the reference; the squared product
    `sq_rmatvec` squares each entry as stored, so a feature named twice
    gives a^2 + b^2."""

    indices: Tensor  # (N, K) or (E, S, K), int32 or int64
    values: Tensor  # same shape, float32
    dim: int
    # Set on the projected shard that game/projector.project_shard
    # registers: the reference keeps such a shard's planes as (K, N), and
    # the checkpoint fingerprint names its shape in that orientation.
    projected: bool = False
    # A random-effect block's transpose plan (`ell_transpose_plan`), which
    # the card's transposes run over; None on a shard and on the CPU.
    plan: Optional["EllTransposePlan"] = None

    @property
    def shape(self) -> Tuple[int, ...]:
        return (*(int(n) for n in self.values.shape[:-1]), int(self.dim))

    @property
    def device(self) -> torch.device:
        return self.values.device

    def matvec(self, w: Tensor) -> Tensor:
        """x_r . w for every row: gather w at the indices, multiply, reduce.
        A block gathers each lane's row of w (E, D), on any device."""
        if self.values.ndim == 2:
            _plain_only(self.values, "matvec")
            return torch.sum(w[self.indices.long()] * self.values.to(w.dtype), dim=-1)
        lanes = self.values.shape[0]
        gathered = torch.gather(w, 1, self.indices.long().reshape(lanes, -1))
        return torch.sum(gathered.view(self.values.shape) * self.values.to(w.dtype), dim=-1)

    def rmatvec(self, u: Tensor) -> Tensor:
        """X^T u by scatter-add (the transpose of `matvec`); per lane on a
        block, u (E, S) -> (E, D)."""
        if self.values.ndim != 2:
            from photon_ml_tpu_torch.ops import ell_kernels

            return ell_kernels.rmatvec(self, u)
        _plain_only(self.values, "rmatvec")
        return self._scatter(self.values.to(u.dtype) * u[:, None])

    def sq_rmatvec(self, u: Tensor) -> Tensor:
        """sum_r u_r x_r^2 per feature (Hessian diagonals); per lane on a
        block."""
        if self.values.ndim != 2:
            from photon_ml_tpu_torch.ops import ell_kernels

            return ell_kernels.rmatvec(self, u, square=True)
        _plain_only(self.values, "sq_rmatvec")
        v = self.values.to(u.dtype)
        return self._scatter(v * v * u[:, None])

    def lanes(self, lo: int, hi: int) -> "SparseFeatures":
        """Lanes [lo, hi) of a block, with a transpose plan of their own on
        the card (over every nonzero entry: it gives the bits of a plan over
        the live rows, since u is 0 on the others)."""
        idx, val = self.indices[lo:hi], self.values[lo:hi]
        plan = ell_transpose_plan(idx, val, self.dim) if val.is_cuda else None
        return SparseFeatures(idx, val, self.dim, plan=plan)

    def _scatter(self, per_entry: Tensor) -> Tensor:
        out = torch.zeros(self.dim, dtype=per_entry.dtype, device=per_entry.device)
        return out.index_add_(0, self.indices.reshape(-1).long(), per_entry.reshape(-1))


Features = Union[Tensor, SparseFeatures]


@dataclasses.dataclass(frozen=True)
class EllTransposePlan:
    """A random-effect block's entries in (lane, feature) order, for its
    transposes on the card (csrc/ell_block.cu): `order` holds the flat
    positions (e * S + s) * K + k of the entries, sorted stably by lane *
    dim + feature from (e, k, s) order, so a run of one cell is in (k, s)
    order, the order in which the reference's scatter adds over its (E, K,
    S) blocks; `run_ptr` the start of each run in `order` (runs + 1);
    `run_out` each run's cell."""

    order: Tensor  # (entries,) int32
    run_ptr: Tensor  # (runs + 1,) int32
    run_out: Tensor  # (runs,) int64
    shape: Tuple[int, int, int]  # the block's (E, S, K)
    dim: int

    @property
    def runs(self) -> int:
        return int(self.run_out.numel())

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.order, self.run_ptr, self.run_out))


def ell_transpose_plan(indices: Tensor, values: Tensor, dim: int,
                       live_rows: Optional[Tensor] = None) -> EllTransposePlan:
    """The transpose plan of an (E, S, K) block, on its device: one stable
    sort of the entries by (lane, feature) and the runs of equal keys. It
    leaves out the entries that add nothing to a product: zero values, and,
    with `live_rows` (E, S), every entry of a row that is not live (a row of
    weight 0, where every u of the objective is 0). The block's structure
    does not change over a solve, so the plan is built once per block."""
    E, S, K = (int(n) for n in values.shape)
    if values.numel() >= 1 << 31:
        raise ValueError(f"a block of {values.numel()} entries is beyond the plan's int32 positions; "
                         "lower max_block_cells")
    keep = values != 0
    if live_rows is not None:
        keep &= live_rows[..., None]
    # Entries enumerated in (e, k, s) order, named by their (e, s, k) position.
    ek, s = torch.nonzero(keep.transpose(1, 2).reshape(E * K, S), as_tuple=True)
    lane = torch.div(ek, K, rounding_mode="floor")
    pos = (lane * S + s) * K + ek % K
    keys = lane * dim + indices.reshape(-1)[pos].long()
    keys, perm = torch.sort(keys, stable=True)
    run_out, counts = torch.unique_consecutive(keys, return_counts=True)
    run_ptr = torch.zeros(run_out.numel() + 1, dtype=torch.int32, device=values.device)
    run_ptr[1:] = torch.cumsum(counts, 0)
    return EllTransposePlan(pos[perm].to(torch.int32), run_ptr, run_out, (E, S, K), int(dim))


# The largest dense block `ell_block_to_dense` builds, in bytes (FULL
# variances densify a chunk of lanes of at most objective.HESSIAN_CHUNK_BYTES;
# chip_smoke.py's float64 holds densify a bucket).
MAX_DENSE_BLOCK_BYTES = 1 << 31


def ell_block_to_dense(block: SparseFeatures) -> Tensor:
    """An ELL block (..., S, K) as the dense (..., S, D) matrix it stands
    for, on its device.

    The entries are added into zeros one ELL position at a time (K
    `scatter_add_` calls), so each call adds at most one entry to a cell and
    a feature named twice in a row is summed in k order: the result is the
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
    for k in range(val.shape[-1]):
        dense.scatter_add_(-1, idx[..., k:k + 1].long(), val[..., k:k + 1])
    return dense


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
