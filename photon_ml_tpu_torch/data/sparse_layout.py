"""Device layout of a sparse fixed-effect shard: CSR in row tiles, and CSC where needed.

Counterpart of `photon_ml_tpu/data/bucketed.py` (the two-level bucketed
layout) and `photon_ml_tpu/data/device_pack.py` (its device-side pack).
That layout exists to suit the TPU's 128-lane `dynamic_gather`
(bucketed.py:11-26); the kernels' contract is on z, g and the objective
value, not on the layout, so the port keeps the entries in the orders its
CUDA kernels (csrc/sparse_glm.cu) read:

  * CSR, row-major, cut into row tiles for the single-stream kernels
    (z = X w, g = X^T u, and the fused value/gradient): each tile starts at a row
    boundary and holds at most TILE entries and TILE_ROWS rows, except a
    row longer than TILE, which is a tile of its own. Beside the CSR
    entries, `tile_perm` gives each entry's 16-bit position in its tile's
    stable sort by column: the fused kernel's forward and the X^T u kernel
    write each entry (or its term) there, and their backward sums each run
    of equal columns once per tile. Slabs are contiguous runs of tiles of
    about equal work, one per block.
  * CSC, column-major, for the backward pass of the two-pass route (X^T u
    and the fused value/gradient when dim is too wide for their
    single-stream kernels): the column's entries are cut into chunks of at
    most CHUNK entries that never straddle a column, a warp per chunk, and
    the chunks of a column are added in order. A hot column is many
    chunks, so it does not stall one warp. It costs 8 bytes an entry and
    is built only where a route may read it (`csc=None`: dim above the
    narrowest single-stream width), or when asked for.

Every order gives fixed-order reductions without float atomics. The layout
is built once per shard on the shard's device with torch ops (a stable sort,
`bincount`, `cumsum`, `searchsorted`): padding and other zero entries are
dropped (an ELL pad would otherwise land on column 0 and make it a hot
column), duplicate (row, col) pairs are summed in their stored order, and
offsets are int64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from photon_ml_tpu_torch.data.containers import SparseFeatures

Tensor = torch.Tensor

# CSC entries per backward work item of the two-pass route (one warp each).
CHUNK = 512
# Row tiles of the single-stream kernels; csrc/sparse_glm.cu sizes its
# shared-memory ring for these two numbers (kTile, kTileRows).
TILE = 2048
TILE_ROWS = 128
# Slabs (blocks of the single-stream kernels) where the device does not say
# how many multiprocessors it has: the CPU, whose plain versions ignore them.
DEFAULT_SLABS = 132
# Widest dim of each single-stream kernel, whose shared memory holds w
# and/or the gradient accumulator beside the tile ring: csrc/sparse_glm.cu's
# Plan<false>, Plan<true> and RmatvecPlan kMaxDim, which its
# `sparse_stream_max_dim` reports. ops/sparse_kernels.py routes by them.
MATVEC_STREAM_MAX_DIM = 28672
FUSED_STREAM_MAX_DIM = 16384
RMATVEC_STREAM_MAX_DIM = 27648
# Above this width some kernel takes its two-pass route, which reads the CSC.
CSC_FROM_DIM = min(MATVEC_STREAM_MAX_DIM, FUSED_STREAM_MAX_DIM, RMATVEC_STREAM_MAX_DIM) + 1


@dataclasses.dataclass(frozen=True)
class SparseLayout:
    """Every nonzero entry of an (n_rows, dim) matrix in CSR, with the row
    tiles, their column order and their slabs; and, where it was built
    (`has_csc`), once more in CSC with its chunk table (else the five CSC
    fields are None). Index planes are int32 (int16 tile-local), offsets
    int64."""

    n_rows: int
    dim: int
    row_ptr: Tensor  # (n_rows + 1,) int64
    col_idx: Tensor  # (nnz,) int32, CSR order
    row_val: Tensor  # (nnz,) float32, CSR order
    col_ptr: Optional[Tensor]  # (dim + 1,) int64
    row_idx: Optional[Tensor]  # (nnz,) int32, CSC order
    col_val: Optional[Tensor]  # (nnz,) float32, CSC order
    chunk_ptr: Optional[Tensor]  # (dim + 1,) int64: column c's chunks are chunk_ptr[c]..chunk_ptr[c+1]
    chunk_start: Optional[Tensor]  # (n_chunks + 1,) int64: chunk k is CSC entries [chunk_start[k], chunk_start[k+1])
    tile_row: Tensor  # (n_tiles + 1,) int64: tile t is rows [tile_row[t], tile_row[t+1])
    tile_ptr: Tensor  # (n_tiles + 1,) int64: ... and CSR entries [tile_ptr[t], tile_ptr[t+1])
    # (nnz,) int16: CSR entry tile_ptr[t] + j of tile t sits at position
    # tile_perm[tile_ptr[t] + j] of the tile's stable sort by column; a tile
    # longer than TILE is one row, already in column order.
    tile_perm: Tensor
    slab_tile: Tensor  # (n_slabs + 1,) int64: slab s is tiles [slab_tile[s], slab_tile[s+1])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.dim)

    @property
    def nnz(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def has_csc(self) -> bool:
        return self.col_ptr is not None

    @property
    def n_chunks(self) -> int:
        return int(self.chunk_start.shape[0]) - 1 if self.has_csc else 0

    @property
    def n_tiles(self) -> int:
        return int(self.tile_row.shape[0]) - 1

    @property
    def n_slabs(self) -> int:
        return int(self.slab_tile.shape[0]) - 1

    @property
    def device(self) -> torch.device:
        return self.row_val.device

    def nbytes(self) -> int:
        """Device bytes of every array the layout holds."""
        return sum(t.numel() * t.element_size() for t in (
            self.row_ptr, self.col_idx, self.row_val, self.col_ptr, self.row_idx, self.col_val,
            self.chunk_ptr, self.chunk_start, self.tile_row, self.tile_ptr, self.tile_perm,
            self.slab_tile) if t is not None)


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


def row_tiles(row_ptr: Tensor) -> Tensor:
    """Greedy row tiles: the first starts at row 0, and each next one at the
    furthest row boundary that keeps the tile within TILE entries and
    TILE_ROWS rows (at least one row further: a row longer than TILE is a
    tile of its own). Returns tile_row, (n_tiles + 1,) int64.

    Each row's next start is one searchsorted; the starts reachable from
    row 0 are then marked by pointer doubling (after step k every start
    fewer than 2^(k+1) tiles from row 0 is marked), so the build takes
    log2(n_tiles) gather/scatter passes instead of a scan over the rows."""
    n = row_ptr.shape[0] - 1
    dev = row_ptr.device
    if n == 0:
        return torch.zeros(1, dtype=torch.int64, device=dev)
    r = torch.arange(n + 1, device=dev)
    end = torch.searchsorted(row_ptr, row_ptr + TILE, right=True) - 1
    nxt = torch.minimum(end, r + TILE_ROWS).clamp_max(n)
    jump = torch.maximum(nxt, (r + 1).clamp_max(n))  # jump[n] = n
    mark = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    mark[0] = 1
    while not bool(mark[n]):
        mark = mark | torch.zeros_like(mark).index_add_(0, jump, mark).clamp_max(1)
        jump = jump[jump]
    return torch.nonzero(mark).reshape(-1)


def slab_table(tile_row: Tensor, tile_ptr: Tensor, n_slabs: int) -> Tensor:
    """Cut the tiles into `n_slabs` contiguous runs of about equal work
    (entries + rows of a tile); slab s starts at the first tile whose work
    before it reaches s / n_slabs of the total. Returns slab_tile,
    (n_slabs + 1,) int64; a slab may be empty."""
    if n_slabs < 1:
        raise ValueError(f"n_slabs must be >= 1, got {n_slabs}")
    cost = (tile_ptr[1:] - tile_ptr[:-1]) + (tile_row[1:] - tile_row[:-1])
    before = torch.cumsum(cost, 0) - cost
    total = int(cost.sum()) if cost.numel() else 0
    targets = torch.tensor([s * total // n_slabs for s in range(n_slabs)], dtype=torch.int64,
                           device=tile_row.device)
    starts = torch.searchsorted(before, targets, side="left")
    return torch.cat([starts, torch.tensor([cost.shape[0]], device=tile_row.device)])


def tile_permutation(tile_ptr: Tensor, cols: Tensor, dim: int) -> Tensor:
    """Each CSR entry's position in its tile's stable sort by column, as a
    16-bit tile-local position (a tile longer than TILE is one row: its
    order is the CSR order, kept modulo 2^16 and never read by the
    kernels)."""
    n_tiles = tile_ptr.shape[0] - 1
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=cols.device),
                                      tile_ptr[1:] - tile_ptr[:-1])
    order = torch.sort(tile_of * dim + cols, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.shape[0], device=cols.device)
    return ((pos - tile_ptr[tile_of]) & 0xFFFF).to(torch.int16)  # two's complement wrap above 2^15


def default_slabs(device: torch.device) -> int:
    """One slab per multiprocessor on a CUDA device, DEFAULT_SLABS elsewhere."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return DEFAULT_SLABS


def from_coo(rows: Tensor, cols: Tensor, vals: Tensor, n_rows: int, dim: int,
             csc: Optional[bool] = None) -> SparseLayout:
    """The layout of the COO triplets, built on their device, with one slab
    per multiprocessor of a CUDA device (`default_slabs`). The CSC copy is
    built if `csc`, or, with `csc=None`, if dim >= CSC_FROM_DIM."""
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
    tile_row = row_tiles(row_ptr)
    tile_ptr = row_ptr[tile_row]
    return SparseLayout(
        n_rows=int(n_rows), dim=int(dim),
        row_ptr=row_ptr, col_idx=cols.int(), row_val=vals,
        **_csc(rows, cols, vals, dim, dim >= CSC_FROM_DIM if csc is None else csc),
        tile_row=tile_row, tile_ptr=tile_ptr, tile_perm=tile_permutation(tile_ptr, cols, dim),
        slab_tile=slab_table(tile_row, tile_ptr, default_slabs(rows.device)),
    )


def _csc(rows: Tensor, cols: Tensor, vals: Tensor, dim: int, build: bool) -> Dict[str, Optional[Tensor]]:
    """The CSC fields of the layout of CSR-ordered entries: built, or None."""
    if not build:
        return dict.fromkeys(("col_ptr", "row_idx", "col_val", "chunk_ptr", "chunk_start"))
    # A stable sort by column keeps the rows of each column ascending.
    corder = torch.sort(cols, stable=True).indices
    col_counts = torch.bincount(cols, minlength=dim)
    col_ptr = _ptr(col_counts)
    n_per_col = (col_counts + CHUNK - 1) // CHUNK
    chunk_ptr = _ptr(n_per_col)
    chunk_col = torch.repeat_interleave(torch.arange(dim, device=cols.device), n_per_col)
    within = torch.arange(chunk_col.shape[0], device=cols.device) - chunk_ptr[chunk_col]
    chunk_start = torch.cat([col_ptr[chunk_col] + within * CHUNK, col_ptr[-1:]])
    return dict(col_ptr=col_ptr, row_idx=rows[corder].int(), col_val=vals[corder],
                chunk_ptr=chunk_ptr, chunk_start=chunk_start)


def from_ell(features: SparseFeatures, csc: Optional[bool] = None) -> SparseLayout:
    """The layout of a 2-D ELL matrix, built on its device (`csc` as in
    `from_coo`)."""
    if features.indices.ndim != 2 or features.indices.shape != features.values.shape:
        raise ValueError("from_ell takes (N, K) ELL planes of one shape")
    n, k = features.indices.shape
    rows = torch.arange(n, device=features.device).repeat_interleave(k)
    return from_coo(rows, features.indices.reshape(-1), features.values.reshape(-1),
                    n, features.dim, csc)
