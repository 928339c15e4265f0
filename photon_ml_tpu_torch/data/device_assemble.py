"""Random-effect assembly as torch ops on the dataset's device: the entity
blocks and the index-map projector.

Port of `photon_ml_tpu/data/device_assemble.py`. Both halves are the same
counting-sort machinery: a stable sort by an integer key, rank = index -
segment start, and a scatter to unique destinations. Stable sorts are
uniquely determined permutations, segment offsets are integer arithmetic
and every scatter destination is unique, so what these programs build is
bit for bit what the reference's host loops and XLA programs build, on the
CPU and on the card alike. This is the only route: the entity layout of
one process and of every rank (parallel/mesh.py) and every index-map
projector come from here, at every size. The packed (entity, feature) keys
are int64, so no key-space limit applies.

Entity blocks (`BlockAssembler`): each entity keeps its first `cap` rows
in the order of a deterministic splitmix64 priority of (entity code, row)
(`row_priorities`), restored to row order; each capacity bucket is an
(entities, capacity) gather matrix into the sample axis plus a 0/1 mask.

Index map (`build_index_tables`, `project_entries`): the sorted distinct
(entity, feature) keys of the nonzero entries give each entity its slots,
slot j being its j-th smallest feature; an entry's local slot is its key's
position in its entity's segment of that sorted set (`searchsorted`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_SIGN = -(1 << 63)  # the int64 sign bit
# An index map's projected width is a multiple of this, as in the reference,
# so slot tables and model shapes match it.
PAD_MULTIPLE = 8


def _u64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: Tensor, s: int) -> Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def row_priorities(codes: Tensor) -> Tensor:
    """The reservoir priority of every row: splitmix64 of (entity code, row
    index), in int64 tensors whose products wrap mod 2^64 as the uint64
    arithmetic of the reference does. Returned with the sign bit flipped,
    so that the signed order of the result is the unsigned order of the
    priorities."""
    rows = torch.arange(codes.shape[0], dtype=torch.int64, device=codes.device)
    x = codes.long() * _u64(0x9E3779B97F4A7C15) + rows * _u64(0xBF58476D1CE4E5B9)
    x = x ^ _shr(x, 30)
    x = x * _u64(0xBF58476D1CE4E5B9)
    x = x ^ _shr(x, 27)
    x = x * _u64(0x94D049BB133111EB)
    x = x ^ _shr(x, 31)
    return x ^ _SIGN


class BlockAssembler:
    """The active rows of one random effect, on the device of `codes`, and
    the scatter of each capacity bucket's blocks from them.

    `codes` (N,) is each sample's entity code; `counts` and `a_counts` (E,)
    host arrays are each entity's rows and the rows it keeps active (0 for
    an entity under the lower bound, at most the cap). `active` holds the
    active rows in (entity, row) order."""

    def __init__(self, codes: Tensor, counts: np.ndarray, a_counts: np.ndarray, kept: np.ndarray,
                 need_reservoir: bool):
        dev = codes.device
        n = codes.shape[0]
        codes = codes.long()
        if need_reservoir:
            o = torch.argsort(row_priorities(codes), stable=True)
            order = o[torch.argsort(codes[o], stable=True)]
        else:
            order = torch.argsort(codes, stable=True)
        num_active = int(a_counts.sum())
        if num_active != n:
            starts1 = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=starts1[1:])
            codes_s = codes[order]
            rank = torch.arange(n, device=dev) - torch.as_tensor(starts1, device=dev)[codes_s]
            order = order[rank < torch.as_tensor(a_counts, dtype=torch.int64, device=dev)[codes_s]]
        if need_reservoir:
            # Back to row order within each entity (the keys are distinct).
            order = order[torch.argsort(codes[order] * n + order)]
        self.active = order
        kept_sizes = torch.as_tensor(a_counts[kept], dtype=torch.int64, device=dev)
        self.a_starts = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(a_counts[kept], out=self.a_starts[1:])
        # Each active row's kept-entity ordinal and its position in that entity.
        self._kept_ord = torch.repeat_interleave(torch.arange(len(kept), device=dev), kept_sizes)
        self._pos = (torch.arange(num_active, device=dev)
                     - torch.as_tensor(self.a_starts, device=dev)[self._kept_ord])

    def bucket_blocks(self, local: np.ndarray, e_pad: int, capacity: int) -> Tuple[Tensor, Tensor]:
        """One bucket's (e_pad, capacity) gather and mask: `local[k]` is
        kept entity k's lane in the bucket (-1: another bucket). Pad lanes
        and slots stay 0 (gather row 0, mask 0)."""
        dev = self.active.device
        li = torch.as_tensor(local, dtype=torch.int64, device=dev)[self._kept_ord]
        mine = li >= 0
        dst = li[mine] * capacity + self._pos[mine]
        gather = torch.zeros(e_pad * capacity, dtype=torch.int64, device=dev)
        mask = torch.zeros(e_pad * capacity, dtype=torch.float32, device=dev)
        gather[dst] = self.active[mine]
        mask[dst] = 1.0
        return gather.view(e_pad, capacity), mask.view(e_pad, capacity)


def build_index_tables(indices: Tensor, values: Tensor, entity_rows: Tensor, num_entities: int,
                       dim: int) -> Tensor:
    """The (E + 1, D_proj) int64 slot tables of an index-map projector:
    row e lists entity e's distinct features (nonzero entries of its rows)
    in increasing order, padded with -1; row E (unseen entities) is empty.
    D_proj is the largest count, rounded up to `PAD_MULTIPLE`."""
    dev = values.device
    dimw = dim + 1
    ent = entity_rows.long()[:, None].expand(indices.shape)
    keep = (values != 0.0) & (ent < num_entities)
    keys = torch.unique(ent[keep] * dimw + indices[keep].long())  # sorted
    pair_ent = torch.div(keys, dimw, rounding_mode="floor")
    pair_idx = keys - pair_ent * dimw
    counts = torch.bincount(pair_ent, minlength=num_entities)
    d_proj = max(1, int(counts.max()) if num_entities else 1)
    d_proj = -(-d_proj // PAD_MULTIPLE) * PAD_MULTIPLE
    starts = torch.zeros(num_entities + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    slot = torch.arange(keys.shape[0], device=dev) - starts[pair_ent]
    tables = torch.full((num_entities + 1, d_proj), -1, dtype=torch.int64, device=dev)
    tables[pair_ent, slot] = pair_idx
    return tables


def table_keys(slot_tables: Tensor, dim: int) -> Tuple[Tensor, Tensor]:
    """(sorted keys entity * (dim + 1) + feature of every valid slot,
    per-row segment offsets (E + 2,)) of slot tables: the tables' valid
    entries in row-major order are already sorted."""
    valid = slot_tables >= 0
    rows = torch.arange(slot_tables.shape[0], device=slot_tables.device)[:, None].expand_as(slot_tables)
    keys = rows[valid] * (dim + 1) + slot_tables[valid]
    offsets = torch.zeros(slot_tables.shape[0] + 1, dtype=torch.int64, device=slot_tables.device)
    torch.cumsum(valid.sum(dim=1), 0, out=offsets[1:])
    return keys, offsets


def project_entries(keys: Tensor, offsets: Tensor, dim: int, indices: Tensor, values: Tensor,
                    entity_rows: Tensor) -> Tuple[Tensor, Tensor]:
    """Rewrite (N, K) ELL planes' global features to their entities' local
    slots (int32); an entry whose feature is not in its entity's table
    (value-0 padding, unseen entities) becomes (slot 0, 0.0)."""
    ent = entity_rows.long()
    entry_keys = ent[:, None] * (dim + 1) + indices.long()
    u = keys.shape[0]
    if u == 0:
        return torch.zeros_like(indices, dtype=torch.int32), torch.zeros_like(values)
    pos = torch.searchsorted(keys, entry_keys.reshape(-1)).view(entry_keys.shape).clamp_max(u - 1)
    hit = (keys[pos] == entry_keys) & (values != 0.0)
    local = pos - offsets[ent][:, None]
    out = torch.where(hit, local, torch.zeros_like(local)).to(torch.int32)
    return out, torch.where(hit, values, torch.zeros_like(values))
