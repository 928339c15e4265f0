"""Ranks of torch.distributed and the cards of one process: meshes, exact collectives, row owners.

Port of `photon_ml_tpu/parallel/mesh.py`: `make_mesh` (:61), the sample
sharding of `shard_game_dataset` (:143) and the entity-lane sharding of
`shard_random_effect_dataset` (:547). A rank is one process with one
explicit device. The JAX package carries its mesh on the arrays' sharding
and lets XLA place the collectives; the port carries a `RankMesh` on the
data and calls three collectives of its own, through which every
cross-rank move of the port goes:

  * `exact_sum`: each rank writes its k partial sums once, as float64,
    into a (k,) buffer; one all_gather fills a (W, k) buffer with every
    rank's, and every rank then adds the rows in rank order in float64
    (`rank_order_sum`: one kernel launch on a CUDA tensor, csrc/
    exact_sum.cu), rounded once to the dtype asked for. Every rank adds the
    same gathered bits in the same order, so every rank holds the same
    bits whatever the backend, and the replicated optimizer iterates, whose
    line-search and stop decisions are taken on the host from these sums,
    never drift apart. A rank sends k values (4 KiB for a 514-wide
    gradient); the buffers are kept for the next call of the same k.
  * `owned_to_global`: each rank places the values it owns at their global
    positions in a zero buffer, and one all_reduce(SUM) follows; every
    position has one owner, so the sum is exact. Scores, labels and
    weights reach the AUC this way, and random-effect coefficient rows the
    assembled model.
  * `exchange`: per-row values move from the rows one rank holds to the
    rows another needs, by an `ExchangePlan` built once from the global
    row placement; one all_to_all_single sends each rank exactly the rows
    it needs from each other rank, and rows that stay are copied. Values
    are moved, never added, so the result is exact. With world size 1
    nothing moves and no collective is called. The checkpoint on ranks
    plans a second kind (`RowBlocks`): random-effect coefficient rows from
    their owners to the contiguous row block each rank writes.

gloo and NCCL take all three on CUDA tensors (gloo moves them through host
memory itself; it takes all_to_all_single with uneven splits, though not
the list form all_to_all); the gather goes into the (W, k) buffer's row
views on gloo and into the buffer itself on NCCL. The caller names the
backend: gloo where ranks share a card or run on the CPU, NCCL where each
rank has a card of its own. Nothing here picks one.

Row ownership follows one random effect, the owner (`shard_game_dataset`):
its layout is built on every rank from the global id tag, each padded
bucket's lanes are split into W contiguous parts (mesh.py:580-590, so every
rank gets as many lanes of each capacity), and a rank holds the entities of
its lanes and every row of those entities, active and passive, in global
row order. Its random-effect coefficient store holds those entities' rows
alone (the counterpart of the JAX package's row-sharded store, game/
coordinate.py:752-790). The fixed effect trains on the same rows. The
sharding keeps every id tag's global codes, so any other random effect's
layout and owners are built on every rank exactly as one process builds
them; such a random effect trains on a `RowView`, the rows of the entities
it owns in that layout, whose features, labels and weights were exchanged
to it once at build time. Each update of it exchanges the residual offsets
to the view and its scores back, where the JAX package lets XLA move the
rows its gathers need (and its ring gather and scatter, mesh.py:358-477,
move coefficient rows, which here stay on their owner). Shards may be
uneven; the weight-0 padding of `pad_game_dataset` (:90) is not needed.

The second half is the in-process mesh (the reference's `make_mesh`,
`surviving_mesh`, `pad_rows_for_mesh`, `put_row_sharded`,
`leading_axis_mesh`, `bcast_gather_rows` and its collective failure
domain, :61-545): a `CardMesh` over cards one process owns, a
`RowShardedMatrix` (a random effect's rows in one block a card), and the
exact gather of rows from the cards that own them (`gather_rows_into`:
each card gathers, the parts reach the home card and are copied into
place, so the result is `matrix[rows]` bit for bit). The serving store
(serving/bundle.py, engine.py, reshard.py) and the transformer's
row-sharded branch use it. A sweep's shard group of several cards trains
on it too: `shard_random_effect_dataset` cuts each bucket's entity axis into
one slice a shard, and `ring_gather_rows` / `ring_scatter_rows` move the
warm starts to the slices and the solutions back to the cards that own
their rows (the reference's ring collectives, :358-476, as exact
selections and card-to-card copies).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import datetime
import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from photon_ml_tpu_torch.data.containers import SparseFeatures
from photon_ml_tpu_torch.data.game_dataset import (
    EntityBlocks,
    EntityLayout,
    GameDataset,
    RandomEffectDataConfig,
    RandomEffectDataset,
    entity_layout,
    factorize_tag,
    pearson_feature_masks,
)
from photon_ml_tpu_torch.device import DeviceLike, resolve_device
from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.utils import faults

Tensor = torch.Tensor

BACKENDS = ("gloo", "nccl")

SOURCE = cuda_build.CSRC_DIR / "exact_sum.cu"

# Launches of the rank-order kernel, counted where it is launched and
# nowhere else (the CPU path does not count).
LAUNCHES: Dict[str, int] = {"rank_sum": 0}

_SUM_DTYPES = (torch.float32, torch.float64)

# The collectives a RankMesh runs, as its counts name them.
COLLECTIVES = ("exact_sum", "owned_to_global", "exchange")


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.exact_rank_sum.argtypes = [p, i, ctypes.c_longlong, p, i, p]
    lib.exact_rank_sum.restype = i
    lib.exact_sum_error_string.argtypes = [i]
    lib.exact_sum_error_string.restype = ctypes.c_char_p


def rank_order_sum_plain(rows: Tensor, dtype: torch.dtype) -> Tensor:
    """The (k,) sum of the (W, k) float64 rows in rank order, rounded once
    to `dtype`."""
    total = rows[0].clone()
    for r in range(1, rows.shape[0]):
        total += rows[r]
    return total.to(dtype)


def rank_order_sum(rows: Tensor, dtype: torch.dtype) -> Tensor:
    """`rank_order_sum_plain`: the CUDA kernel (csrc/exact_sum.cu) for a
    CUDA tensor, the plain version for a CPU one; the same bits either way."""
    if rows.dtype != torch.float64 or rows.ndim != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (W, k) float64 tensor")
    if dtype not in _SUM_DTYPES:
        raise TypeError(f"the sum is float32 or float64, not {dtype}")
    if rows.device.type == "cpu":
        return rank_order_sum_plain(rows, dtype)
    lib = cuda_build.load_library(SOURCE, _bind)
    world, k = rows.shape
    out = torch.empty((k,), dtype=dtype, device=rows.device)
    with torch.cuda.device(rows.device):
        rc = lib.exact_rank_sum(rows.data_ptr(), world, k, out.data_ptr(),
                                int(dtype == torch.float32),
                                torch.cuda.current_stream(rows.device).cuda_stream)
    cuda_build.check_rc(rc, "exact_rank_sum launch", lib.exact_sum_error_string)
    cuda_build.count_launch(LAUNCHES, "rank_sum")
    return out


class RankMesh:
    """This process's place among the ranks: rank, world size, backend and
    device. `counts` tallies the collectives this rank has run, `elements`
    the values it sent in them, and `seconds` the host time spent in their
    collective calls, which includes waiting for the device work queued
    before them."""

    def __init__(self, rank: int, world_size: int, backend: str, device: torch.device):
        self.rank = rank
        self.world_size = world_size
        self.backend = backend
        self.device = device
        self.counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.elements: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.seconds: Dict[str, float] = {k: 0.0 for k in COLLECTIVES}
        self._gathers: Dict[int, Tuple[Tensor, Tensor, List[Tensor]]] = {}

    def __repr__(self) -> str:
        return (f"RankMesh(rank={self.rank}, world_size={self.world_size}, "
                f"backend={self.backend!r}, device={str(self.device)!r})")

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0
            self.elements[k] = 0
            self.seconds[k] = 0.0

    def _collective(self, what: str, elements: int, run) -> None:
        t0 = time.perf_counter()
        run()
        self.seconds[what] += time.perf_counter() - t0
        self.counts[what] += 1
        self.elements[what] += elements

    def _gather_buffers(self, k: int) -> Tuple[Tensor, Tensor, List[Tensor]]:
        """(send (k,), gathered (W, k), its row views), float64, kept per k."""
        if k not in self._gathers:
            send = torch.empty((k,), dtype=torch.float64, device=self.device)
            rows = torch.empty((self.world_size, k), dtype=torch.float64, device=self.device)
            self._gathers[k] = (send, rows, list(rows.unbind(0)))
        return self._gathers[k]

    def exact_sum(self, parts: Sequence[Tensor], dtype: torch.dtype = torch.float64) -> List[Tensor]:
        """The float64 sum over ranks of each part (any shapes, any float
        dtype), rounded once to `dtype` (float64 or float32), the same bits
        on every rank; see the module docstring."""
        sizes = [p.numel() for p in parts]
        send, rows, row_views = self._gather_buffers(sum(sizes))
        for dst, p in zip(send.split(sizes), parts):
            dst.copy_(p.reshape(-1))
        if self.backend == "nccl":
            gather = lambda: dist.all_gather_into_tensor(rows, send)
        else:
            gather = lambda: dist.all_gather(row_views, send)
        self._collective("exact_sum", send.numel(), gather)
        total = rank_order_sum(rows, dtype)
        return [t.reshape(p.shape) for t, p in zip(total.split(sizes), parts)]

    def owned_to_global(self, values: Tensor, global_rows: Tensor, n: int) -> Tensor:
        """(n, ...) with this rank's `values` (m, ...) at `global_rows` (m,)
        and every other rank's at theirs; each position must have exactly
        one owner over all ranks (positions without one come out zero)."""
        buf = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype, device=self.device)
        buf[global_rows.to(self.device)] = values.to(self.device)
        self._collective("owned_to_global", buf.numel(), lambda: dist.all_reduce(buf))
        return buf

    def exchange(self, values: Tensor, plan: "ExchangePlan") -> Tensor:
        """The (plan.num_dst, ...) rows `plan` builds from this rank's
        (plan.num_src, ...) `values` and every other rank's: rows that stay
        are copied, the others arrive by one all_to_all_single (none at
        world size 1). Every rank calls it with its own part of one plan."""
        if values.shape[0] != plan.num_src:
            raise ValueError(f"the plan moves {plan.num_src} source rows, got {values.shape[0]}")
        values = values.to(self.device)
        row_shape = tuple(values.shape[1:])
        out = values.new_empty((plan.num_dst,) + row_shape)
        out[plan.keep_dst] = values[plan.keep_src]
        if self.world_size > 1:
            width = int(np.prod(row_shape, dtype=np.int64))
            send = values[plan.send_rows].reshape(-1)
            recv = values.new_empty((len(plan.recv_rows) * width,))
            self._collective("exchange", send.numel(), lambda: dist.all_to_all_single(
                recv, send, [c * width for c in plan.recv_counts],
                [c * width for c in plan.send_counts]))
            out[plan.recv_rows] = recv.view((-1,) + row_shape)
        return out

    def all_true(self, flag: bool) -> bool:
        """Whether `flag` holds on every rank (an exact sum of 0/1 votes)."""
        (votes,) = self.exact_sum([torch.tensor(float(flag), device=self.device)])
        return int(votes) == self.world_size

    def close(self) -> None:
        dist.destroy_process_group()


def over_ranks(mesh: Optional[RankMesh], *sums: Tensor) -> Tuple[Tensor, ...]:
    """Raw sums over every rank's rows, through one `exact_sum`, in the
    dtype each came in (float32 sums are rounded once, by the rank-order
    kernel); unchanged without a mesh. Every cross-rank sum of the objective goes through
    here, whatever produced the per-rank sums."""
    if mesh is None:
        return sums
    f32 = all(s.dtype == torch.float32 for s in sums)
    totals = mesh.exact_sum(sums, torch.float32 if f32 else torch.float64)
    return tuple(t.to(s.dtype) for t, s in zip(totals, sums))


def init_rank_mesh(
    *,
    backend: str,
    rank: int,
    world_size: int,
    device: DeviceLike,
    store: Optional[dist.Store] = None,
    init_method: Optional[str] = None,
    timeout_s: float = 600.0,
) -> RankMesh:
    """Join the process group and return this rank's mesh.

    The caller names the backend (gloo or NCCL) and this rank's device, and
    gives either a `store` or an `init_method`; `timeout_s` bounds every
    collective, so a rank stuck in one fails instead of hanging."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if (store is None) == (init_method is None):
        raise ValueError("give exactly one of store and init_method")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            raise ValueError(f"name the card of this rank (cuda:<index>), got {str(dev)!r}")
        torch.cuda.set_device(dev)
    elif backend == "nccl":
        raise ValueError("the NCCL backend needs a CUDA device on every rank")
    dist.init_process_group(
        backend, init_method=init_method, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return RankMesh(rank, world_size, backend, dev)


def rank_mesh_from_env(*, backend: str, device: DeviceLike, timeout_s: float = 600.0) -> RankMesh:
    """The mesh of a rank started by `torchrun`, from the RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT it sets; the device is the caller's choice
    (typically f"cuda:{os.environ['LOCAL_RANK']}")."""
    return init_rank_mesh(
        backend=backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]),
        device=device, init_method="env://", timeout_s=timeout_s,
    )


# ------------------------------------------------------------ row ownership


def _layout_key(config: RandomEffectDataConfig) -> RandomEffectDataConfig:
    """What decides a layout: everything but the feature shard."""
    return dataclasses.replace(config, feature_shard="")


def entity_owners(layout: EntityLayout, world_size: int) -> np.ndarray:
    """Owning rank of every entity code: a bucket chunk's lanes, padded to a
    multiple of W, split into W contiguous parts; entities in no bucket by
    contiguous ranges of entity code."""
    num_e = layout.num_entities
    owner = np.full(num_e, -1, np.int64)
    for _, _, ent_rows in layout.blocks:
        ent_rows = ent_rows.numpy()
        part = -(-len(ent_rows) // world_size)
        lanes = np.nonzero(ent_rows < num_e)[0]
        owner[ent_rows[lanes]] = lanes // part
    rest = np.nonzero(owner < 0)[0]
    owner[rest] = np.arange(len(rest), dtype=np.int64) * world_size // max(len(rest), 1)
    return owner


def rank_positions(row_rank: np.ndarray) -> np.ndarray:
    """Each global row's position among the rows of its rank (a rank holds
    its rows in global order)."""
    order = np.argsort(row_rank, kind="stable")
    starts = np.zeros(int(row_rank.max(initial=-1)) + 2, np.int64)
    np.cumsum(np.bincount(row_rank, minlength=len(starts) - 1), out=starts[1:])
    pos = np.empty(len(row_rank), np.int64)
    pos[order] = np.arange(len(row_rank), dtype=np.int64) - starts[row_rank[order]]
    return pos


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """This rank's part of one exchange (`RankMesh.exchange`): destination
    row `keep_dst[i]` is source row `keep_src[i]` of this rank; the source
    rows `send_rows` go to the other ranks, `send_counts[r]` of them to
    rank r, and the rows arriving from rank r, `recv_counts[r]` of them, land
    at destination rows `recv_rows`, grouped by rank in rank order and in
    global row order within a rank (so both ends list the same rows in the
    same order). Positions are rows of the rank's own source and
    destination tensors, on the mesh's device."""

    num_src: int
    num_dst: int
    keep_src: Tensor
    keep_dst: Tensor
    send_rows: Tensor
    send_counts: Tuple[int, ...]
    recv_rows: Tensor
    recv_counts: Tuple[int, ...]

    @property
    def rows_sent(self) -> int:
        return len(self.send_rows)

    def inverse(self) -> "ExchangePlan":
        """The plan that moves the destination rows back to the source rows."""
        return ExchangePlan(self.num_dst, self.num_src, self.keep_dst, self.keep_src,
                            self.recv_rows, self.recv_counts, self.send_rows, self.send_counts)


def exchange_plan(src_rank: np.ndarray, dst_rank: np.ndarray, rank: int, world_size: int,
                  device: torch.device) -> ExchangePlan:
    """The plan that gives every rank the global rows `dst_rank` places on
    it, from the ranks `src_rank` places them on; both (N,) arrays are the
    same on every rank, and each rank holds its rows in global order."""
    src_pos, dst_pos = rank_positions(src_rank), rank_positions(dst_rank)
    mine_src, mine_dst = src_rank == rank, dst_rank == rank
    keep = np.nonzero(mine_src & mine_dst)[0]

    def grouped(rows: np.ndarray, by: np.ndarray, pos: np.ndarray):
        order = np.argsort(by[rows], kind="stable")
        counts = np.bincount(by[rows], minlength=world_size)
        return torch.as_tensor(pos[rows[order]]).to(device), tuple(int(c) for c in counts)

    send_rows, send_counts = grouped(np.nonzero(mine_src & ~mine_dst)[0], dst_rank, src_pos)
    recv_rows, recv_counts = grouped(np.nonzero(mine_dst & ~mine_src)[0], src_rank, dst_pos)
    return ExchangePlan(int(mine_src.sum()), int(mine_dst.sum()),
                        torch.as_tensor(src_pos[keep]).to(device),
                        torch.as_tensor(dst_pos[keep]).to(device),
                        send_rows, send_counts, recv_rows, recv_counts)


def block_bounds(num_rows: int, world_size: int) -> np.ndarray:
    """The W + 1 boundaries of W contiguous row blocks, np.array_split's
    (the first num_rows % W blocks one row longer)."""
    sizes = num_rows // world_size + (np.arange(world_size) < num_rows % world_size)
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """A random effect's coefficient rows as the elastic checkpoint writes
    them: rank k writes the global rows [bounds[k], bounds[k + 1]) of the
    (E + 1)-row matrix (the pinned zero row is row E, in the last block),
    and `plan` moves each owned row from its owner's store to the rank
    that writes it, once (`RankMesh.exchange`; the pinned row is the last
    rank's to send)."""

    plan: ExchangePlan
    bounds: np.ndarray

    @property
    def num_rows(self) -> int:
        return int(self.bounds[-1])


def row_blocks_plan(owner: np.ndarray, rank: int, world_size: int,
                    device: torch.device) -> RowBlocks:
    """The `RowBlocks` of a random effect whose entity e is owned by rank
    `owner[e]` (the same (E,) array on every rank)."""
    bounds = block_bounds(len(owner) + 1, world_size)
    src = np.append(np.asarray(owner, np.int64), world_size - 1)
    dst = np.repeat(np.arange(world_size, dtype=np.int64), np.diff(bounds))
    return RowBlocks(exchange_plan(src, dst, rank, world_size, device), bounds)


@dataclasses.dataclass
class RowView:
    """A random effect's rows on a rank whose rows follow another random
    effect: the rows of the entities this rank owns in its layout, in
    global row order (`global_rows`), as a dataset of that random effect's
    feature shard, labels and weights, exchanged from the ranks holding
    them once. `to_view` moves per-row values of the rank's own rows to the
    view (residual offsets), `from_view` moves the view's back (scores)."""

    dataset: GameDataset
    global_rows: np.ndarray
    to_view: ExchangePlan
    from_view: ExchangePlan


@dataclasses.dataclass
class RowSharding:
    """Which of the global rows a rank holds, the random-effect layout
    (built from the global id tag) that decided it, the rank that holds
    every global row, and every id tag of all rows factorized (as
    `factorize_tag` gives it), from which any random effect's global layout
    and any grouped evaluator's groups are built as one process builds
    them."""

    mesh: RankMesh
    global_rows: Tensor  # (n_local,) int64 on the mesh's device, increasing
    num_global: int
    owner_config: Optional[RandomEffectDataConfig] = None
    layout: Optional[EntityLayout] = None
    entity_owner: Optional[np.ndarray] = None
    row_rank: Optional[np.ndarray] = None  # (N,) int64
    tag_codes: Dict[str, Tuple[np.ndarray, np.ndarray]] = dataclasses.field(default_factory=dict)
    # Each random effect's entity owners and its checkpoint row blocks, by
    # layout (filled as the random effects are built).
    _owners: Dict[RandomEffectDataConfig, np.ndarray] = dataclasses.field(default_factory=dict)
    _row_blocks: Dict[RandomEffectDataConfig, RowBlocks] = dataclasses.field(default_factory=dict)

    def row_blocks(self, config: RandomEffectDataConfig) -> RowBlocks:
        """The checkpoint's row blocks of the random effect built from
        `config` on this sharding, planned once and kept."""
        key = _layout_key(config)
        if key not in self._row_blocks:
            if key not in self._owners:
                raise ValueError(f"no random effect of {config.random_effect_type!r} was built "
                                 "on this sharding")
            self._row_blocks[key] = row_blocks_plan(self._owners[key], self.mesh.rank,
                                                    self.mesh.world_size, self.mesh.device)
        return self._row_blocks[key]

    def gather(self, values: Tensor) -> Tensor:
        """The global (N, ...) tensor of per-row values every rank holds for
        its own rows."""
        return self.mesh.owned_to_global(values, self.global_rows, self.num_global)

    def _row_view(self, dataset: GameDataset, layout: EntityLayout,
                  owner: np.ndarray, shard: str) -> RowView:
        mesh = self.mesh
        view_rank = owner[layout.codes.numpy()]
        to_view = exchange_plan(self.row_rank, view_rank, mesh.rank, mesh.world_size, mesh.device)
        feats = dataset.shards[shard]
        if isinstance(feats, SparseFeatures):
            feats = SparseFeatures(mesh.exchange(feats.indices, to_view),
                                   mesh.exchange(feats.values, to_view), feats.dim)
        else:
            feats = mesh.exchange(feats, to_view)
        labels, weights = mesh.exchange(torch.stack([dataset.labels, dataset.weights], 1),
                                        to_view).T.contiguous()
        view = GameDataset({shard: feats}, labels, torch.zeros_like(labels), weights, {})
        return RowView(view, np.nonzero(view_rank == mesh.rank)[0], to_view, to_view.inverse())

    def random_effect_dataset(self, dataset: GameDataset,
                              config: RandomEffectDataConfig) -> RandomEffectDataset:
        """This rank's part of the layout: its lanes of every bucket chunk
        (a chunk where they hold no entity is skipped), gathers remapped to
        the rows the lanes train on, and coefficient rows remapped to this
        rank's store: row i is entity `owned_entities[i]`, row
        len(owned_entities) the pinned zero row. The entity index stays
        global. The owner's random effect trains on this rank's rows; any
        other on a `RowView` (built here: its exchanges are collectives, so
        every rank builds it). Pearson masks are computed for the owned
        entities from their active rows, all on this rank, in float64 on the
        host as one process computes them; mask row i is store row i."""
        mesh = self.mesh
        world, dev = mesh.world_size, dataset.device
        view = None
        if self.layout is not None and _layout_key(config) == _layout_key(self.owner_config):
            layout, owner = self.layout, self.entity_owner
            rows, rows_ds = self.global_rows.cpu().numpy(), dataset
        else:
            tag = config.random_effect_type
            if tag not in self.tag_codes:
                raise ValueError(f"id tag {tag!r} not present")
            layout = entity_layout(self.tag_codes[tag], config, torch.device("cpu"))
            owner = entity_owners(layout, world)
            view = self._row_view(dataset, layout, owner, config.feature_shard)
            rows, rows_ds = view.global_rows, view.dataset
        self._owners[_layout_key(config)] = owner
        num_e = layout.num_entities
        local_pos = np.full(self.num_global, -1, np.int64)
        local_pos[rows] = np.arange(len(rows), dtype=np.int64)
        owned = np.nonzero(owner == mesh.rank)[0]
        store_row = np.full(num_e + 1, -1, np.int64)
        store_row[owned] = np.arange(len(owned), dtype=np.int64)
        store_row[num_e] = len(owned)
        sample_rows = store_row[layout.codes.numpy()[rows]]
        if (sample_rows < 0).any():
            raise RuntimeError("a row of another rank's entity is on this rank")
        buckets = []
        for gather, mask, ent_rows in layout.blocks:
            gather, mask, ent_rows = gather.numpy(), mask.numpy(), ent_rows.numpy()
            pad = (-len(ent_rows)) % world
            if pad:
                gather = np.concatenate([gather, np.zeros((pad, gather.shape[1]), np.int64)])
                mask = np.concatenate([mask, np.zeros((pad, mask.shape[1]), np.float32)])
                ent_rows = np.concatenate([ent_rows, np.full(pad, num_e, np.int64)])
            part = len(ent_rows) // world
            sl = slice(mesh.rank * part, (mesh.rank + 1) * part)
            g, m, e = gather[sl], mask[sl], ent_rows[sl]
            if not (e < num_e).any():
                continue
            lg = np.where(m > 0, local_pos[g], 0)
            if (lg < 0).any() or (store_row[e] < 0).any():
                raise RuntimeError("an entity's lane or active row is not on its owning rank")
            buckets.append(EntityBlocks(torch.as_tensor(lg).to(dev), torch.as_tensor(m).to(dev),
                                        torch.as_tensor(store_row[e]).to(dev)))
        feature_mask = None
        if config.num_features_to_samples_ratio_upper_bound is not None:
            kept = layout.kept[owner[layout.kept] == mesh.rank]
            seg = np.searchsorted(layout.kept, kept)
            active, starts = layout.active_rows.numpy(), layout.a_starts
            lists = [local_pos[active[starts[i]:starts[i + 1]]] for i in seg]
            feature_mask = torch.as_tensor(pearson_feature_masks(
                rows_ds, config, lists, list(store_row[kept]), len(owned))).to(dev)
        num_active = int(sum(float(b.mask.sum()) for b in buckets))
        return RandomEffectDataset(
            config=config,
            entity_index=layout.entity_index,
            buckets=buckets,
            sample_entity_rows=torch.as_tensor(sample_rows).to(dev),
            num_active_samples=num_active,
            num_passive_samples=rows_ds.num_samples - num_active,
            feature_mask=feature_mask,
            owned_entities=torch.as_tensor(owned).to(dev),
            view=view,
        )


def _take_rows(x, rows: np.ndarray):
    """Rows of a host array, CPU tensor or ELL SparseFeatures."""
    if isinstance(x, SparseFeatures):
        idx = torch.from_numpy(rows)
        return SparseFeatures(torch.as_tensor(x.indices)[idx], torch.as_tensor(x.values)[idx], x.dim)
    if isinstance(x, Tensor):
        return x[torch.from_numpy(rows)]
    return np.asarray(x)[rows]


def shard_game_dataset(
    mesh: RankMesh,
    shards: Mapping[str, object],
    labels,
    *,
    offsets=None,
    weights=None,
    id_tags: Optional[Mapping[str, Sequence]] = None,
    tag_codes: Optional[Mapping[str, Tuple[np.ndarray, np.ndarray]]] = None,
    owner: Optional[RandomEffectDataConfig] = None,
) -> GameDataset:
    """This rank's GameDataset, on its device, from the host arrays of ALL
    rows (numpy, CPU tensors or `SparseFeatures`), which every rank passes
    alike. An id tag comes as its values (`id_tags`) or factorized
    (`tag_codes`: codes into a value table, as ingest gives them and as
    `GameDataset.build` takes them; entities are then in the table's order).

    With `owner`, a rank holds the rows of the entities it owns in that
    random effect (see the module docstring), and `build_random_effect_
    dataset` with that config gives its part of the layout; any other
    random effect trains on a `RowView`. Without one, the rows are split
    into W contiguous ranges."""
    n = len(labels)
    codes = {k: (np.asarray(c, np.int64), np.asarray(t)) for k, (c, t) in (tag_codes or {}).items()}
    for k, v in (id_tags or {}).items():
        if k not in codes:
            codes[k] = factorize_tag(np.asarray(v))
    layout = entity_owner = None
    if owner is not None:
        if owner.random_effect_type not in codes:
            raise ValueError(f"id tag {owner.random_effect_type!r} not present")
        layout = entity_layout(codes[owner.random_effect_type], owner, torch.device("cpu"))
        entity_owner = entity_owners(layout, mesh.world_size)
        row_rank = entity_owner[layout.codes.numpy()]
    else:
        world = mesh.world_size  # np.array_split's ranges: the first n % W one longer
        row_rank = np.repeat(np.arange(world, dtype=np.int64),
                             n // world + (np.arange(world) < n % world))
    rows = np.nonzero(row_rank == mesh.rank)[0]
    ds = GameDataset.build(
        {k: _take_rows(v, rows) for k, v in shards.items()},
        _take_rows(labels, rows),
        offsets=None if offsets is None else _take_rows(offsets, rows),
        weights=None if weights is None else _take_rows(weights, rows),
        id_tags={k: table[c[rows]] for k, (c, table) in codes.items()},
        tag_codes={k: (c[rows], table) for k, (c, table) in codes.items()},
        device=mesh.device,
    )
    ds.sharding = RowSharding(mesh, torch.as_tensor(rows).to(mesh.device), n, owner, layout,
                              entity_owner, row_rank, codes)
    return ds


# ------------------------------------------------------------ cards of one process
# The in-process mesh: one process owning several cards (the reference's
# `make_mesh`, `surviving_mesh`, `matrix_row_sharding`, `put_row_sharded`,
# `leading_axis_mesh`, `pad_rows_for_mesh`, `bcast_gather_rows`, :61-545).
# A random effect's coefficient matrix is row-sharded over such a mesh as a
# `RowShardedMatrix`: S row blocks of ceil(rows / S) rows, block k on card k.
# `DTensor` is not used: it needs a process group with one device a rank,
# which a serving process that owns several cards is not.

# The CPU's cards: a mesh "over every card" on the CPU has this many shards,
# as many as the reference's tests' host platform devices
# (tests/conftest.py, --xla_force_host_platform_device_count=8). The CPU
# has no card: its shards are ordinals of one device, which is what lets
# the CPU tests plan and move rows as the reference does over its devices.
CPU_CARDS = 8


def local_cards(device: DeviceLike = "cuda") -> List[torch.device]:
    """Every card of `device`'s kind in this process: the CUDA cards, or
    CPU_CARDS ordinals of the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_CARDS


def card_of(device: DeviceLike) -> int:
    """The card identity of a whole-device placement (a replicated matrix):
    a CUDA card's index, 0 on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    return torch.cuda.current_device() if dev.index is None else int(dev.index)


@dataclasses.dataclass(frozen=True)
class CardMesh:
    """A 1-D mesh over cards of one process: shard k lives on `devices[k]`
    and is card `cards[k]`. Card identities are distinct: distinct CUDA
    cards are their indices; shards that share a device (the CPU, or
    several shards on one card) are their positions 0..S-1. A reshard plan
    compares identities, as the reference's compares device objects."""

    devices: Tuple[torch.device, ...]
    cards: Tuple[int, ...]

    def __post_init__(self):
        if not self.devices or len(self.devices) != len(self.cards):
            raise ValueError(f"a mesh needs one card identity a device: {self.devices}, {self.cards}")
        if len(set(self.cards)) != len(self.cards):
            raise ValueError(f"card identities repeat: {self.cards}")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh spans one device kind: {self.devices}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_mesh(devices: Optional[Sequence[DeviceLike]] = None, *, device: DeviceLike = "cuda") -> CardMesh:
    """A mesh over `devices` (default: every card of `device`'s kind,
    `local_cards`). A CUDA card that does not exist raises."""
    devs = [resolve_device(d) for d in (local_cards(device) if devices is None else devices)]
    if not devs:
        raise ValueError("a mesh needs at least one card")
    for i, d in enumerate(devs):
        if d.type == "cuda":
            if d.index is None:
                devs[i] = d = torch.device("cuda", torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise ValueError(f"{d} is not a card of this process "
                                 f"({torch.cuda.device_count()} cards)")
    idx = [d.index for d in devs]
    if devs[0].type == "cuda" and len(set(idx)) == len(idx):
        cards = tuple(idx)
    else:
        cards = tuple(range(len(devs)))
    return CardMesh(tuple(devs), cards)


def surviving_mesh(n_devices: int, *, device: DeviceLike = "cuda") -> Optional[CardMesh]:
    """A mesh over the first `n_devices` cards of `device`'s kind (capped
    at the cards there are); None for n <= 1, the replicated layout."""
    cards = local_cards(device)
    n = max(1, min(int(n_devices), len(cards)))
    if n <= 1:
        return None
    return make_mesh(cards[:n])


def pad_rows_for_mesh(n_rows: int, mesh: CardMesh) -> int:
    """`n_rows` rounded up to a multiple of the mesh's shard count."""
    return -(-int(n_rows) // mesh.size) * mesh.size


class RowShardedMatrix:
    """A (rows, dim) float32 matrix row-sharded over a CardMesh: block k,
    rows [k * rows_per_shard, (k + 1) * rows_per_shard), on
    `mesh.devices[k]`; rows past `logical_rows` (E + 1) are zeros. Its
    `shape` is the padded one."""

    def __init__(self, blocks: Sequence[Tensor], mesh: CardMesh, logical_rows: int):
        blocks = tuple(blocks)
        if len(blocks) != mesh.size or len({tuple(b.shape) for b in blocks}) != 1:
            raise ValueError(f"{len(blocks)} blocks of shapes {[tuple(b.shape) for b in blocks]} "
                             f"for a mesh of {mesh.size}")
        for b, d in zip(blocks, mesh.devices):
            if b.device != d:
                raise ValueError(f"a block on {b.device} for a shard of {d}")
        self.blocks = blocks
        self.mesh = mesh
        self.logical_rows = int(logical_rows)
        self.rows_per_shard = int(blocks[0].shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows_per_shard * self.mesh.size, int(self.blocks[0].shape[1]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    def numel(self) -> int:
        return sum(int(b.numel()) for b in self.blocks)

    def element_size(self) -> int:
        return self.blocks[0].element_size()

    def host(self) -> np.ndarray:
        """The padded matrix in host memory, block by block."""
        return np.concatenate([b.detach().cpu().numpy() for b in self.blocks])


def put_row_sharded(matrix, mesh: CardMesh, *, logical_rows: Optional[int] = None) -> RowShardedMatrix:
    """A private row-sharded copy of `matrix` (a tensor, a host array or a
    RowShardedMatrix) over `mesh`: rows padded with zeros to a mesh
    multiple, each block copied to its card. `logical_rows` defaults to the
    matrix's own (a RowShardedMatrix's, else its row count)."""
    if isinstance(matrix, RowShardedMatrix):
        logical = matrix.logical_rows if logical_rows is None else int(logical_rows)
        if matrix.mesh == mesh:
            return RowShardedMatrix([b.clone() for b in matrix.blocks], mesh, logical)
        matrix = matrix.host()[:logical]
    src = torch.as_tensor(matrix).detach()
    logical = int(src.shape[0]) if logical_rows is None else int(logical_rows)
    n_rows = pad_rows_for_mesh(max(int(src.shape[0]), logical), mesh)
    per = n_rows // mesh.size
    blocks = []
    for k, dev in enumerate(mesh.devices):
        block = torch.zeros((per, int(src.shape[1])), dtype=torch.float32, device=dev)
        lo, hi = k * per, min((k + 1) * per, int(src.shape[0]))
        if hi > lo:
            block[: hi - lo].copy_(src[lo:hi])
        blocks.append(block)
    for dev in {d for d in mesh.devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return RowShardedMatrix(blocks, mesh, logical)


def leading_axis_mesh(array) -> Optional[CardMesh]:
    """The mesh `array` is row-sharded over, if it is a RowShardedMatrix
    (whose rows always divide over its shards), else None: the one
    inspector behind the bundle's adoption of a sharded matrix and the
    transformer's sharded branch."""
    return array.mesh if isinstance(array, RowShardedMatrix) else None


# The reference's collective failure domain (:208-246): a host-dispatched
# collective runs under the `collective` fault site with bounded re-dispatch
# (PHOTON_COLLECTIVE_RETRIES, counted in `collective_retries`). The gathers
# are deterministic, so a re-dispatch reproduces the same bits. The serving
# engine's bucket program gathers without the site (the reference traces
# that gather under jit, where the site is never passed).
_COLLECTIVE_STATE = threading.local()


@contextlib.contextmanager
def collective_faults_suppressed():
    """A scope in which `dispatch_collective` fires no fault site: a
    degraded path must keep working while the primary is broken."""
    prev = getattr(_COLLECTIVE_STATE, "suppressed", False)
    _COLLECTIVE_STATE.suppressed = True
    try:
        yield
    finally:
        _COLLECTIVE_STATE.suppressed = prev


def collective_retry_policy():
    """1 + PHOTON_COLLECTIVE_RETRIES attempts under the standard backoff."""
    from photon_ml_tpu_torch.utils.knobs import get_knob

    return faults.bounded_policy(int(get_knob("PHOTON_COLLECTIVE_RETRIES")))


def dispatch_collective(fn, *, label: str):
    """Run one host-dispatched collective under the `collective` fault site
    with bounded re-dispatch; exhausted retries propagate."""
    if getattr(_COLLECTIVE_STATE, "suppressed", False):
        return fn()

    def attempt():
        faults.fault_point("collective")
        return fn()

    return faults.retry(attempt, collective_retry_policy(), label=f"collective dispatch {label}",
                        counter="collective_retries")


def gather_rows_into(out: Tensor, matrix: RowShardedMatrix, rows: Tensor, *,
                     host_rows: Optional[Tensor] = None,
                     streams: Optional[Mapping[torch.device, "torch.cuda.Stream"]] = None) -> Tensor:
    """out[i] = matrix[rows[i]], bit for bit, on `out`'s (home) device:
    each card gathers every asked row's offset in its block (rows %
    rows_per_shard), the parts reach the home card, and each is copied into
    place where its card owns the row (a selection: no add, so -0.0 and
    every other value keep their bits; a row no card owns, past the padding
    or negative, keeps `out`'s value). `rows` lies on the home card. A
    card other than the home one takes its indices from `host_rows` (a
    pinned host copy) or from `rows`, and gathers and sends its part on
    `streams[card]` (default: its current stream); the home card's current
    stream waits on an event recorded after each send before it reads the
    part. No fault site: the engine's bucket program calls this directly."""
    home = out.device
    per = matrix.rows_per_shard
    owner = torch.div(rows, per, rounding_mode="floor")
    local = rows - owner * per
    for k, block in enumerate(matrix.blocks):
        if block.device == home:
            part = block[local]
        else:
            stream = streams[block.device] if streams else torch.cuda.current_stream(block.device)
            with torch.cuda.stream(stream):
                src = (host_rows if host_rows is not None else rows).to(block.device, non_blocking=True)
                part = block[src.remainder(per)].to(home, non_blocking=True)
                sent = torch.cuda.Event()
                sent.record(stream)
            torch.cuda.current_stream(home).wait_event(sent)
        torch.where((owner == k)[:, None], part, out, out=out)
    return out


def bcast_gather_rows(matrix: RowShardedMatrix, rows: Tensor) -> Tensor:
    """matrix[rows] for a row-sharded matrix, on `rows`' device, bit for
    bit (`gather_rows_into`), dispatched under the `collective` fault site
    (`dispatch_collective`): the transformer's and validation scoring's
    gather."""

    def gather() -> Tensor:
        out = torch.zeros((int(rows.shape[0]), matrix.shape[1]), dtype=matrix.dtype, device=rows.device)
        return gather_rows_into(out, matrix, rows)

    return dispatch_collective(gather, label="bcast_gather_rows")


def bcast_gather_wire_bytes(mesh: CardMesh, n_rows: int, dim: int) -> int:
    """The reference's analytic wire bytes of one `bcast_gather_rows` call
    of float32 rows (a ring all-reduce of the (n_rows, dim) block:
    2 * (S - 1) * its bytes)."""
    return 2 * (mesh.size - 1) * int(n_rows) * int(dim) * 4


def sharded_zeros(mesh: CardMesh, logical_rows: int, dim: int) -> RowShardedMatrix:
    """A zero (logical_rows, dim) float32 RowShardedMatrix over `mesh`,
    each block made on its card."""
    per = pad_rows_for_mesh(logical_rows, mesh) // mesh.size
    return RowShardedMatrix([torch.zeros((per, int(dim)), dtype=torch.float32, device=d)
                             for d in mesh.devices], mesh, logical_rows)


def _owned_parts(matrix: RowShardedMatrix, rows: Tensor):
    """(block index, positions in `rows`, rows within that block) for every
    block that owns some of `rows`, as host index tensors."""
    per = matrix.rows_per_shard
    r = rows.detach().to("cpu", torch.int64)
    owner = torch.div(r, per, rounding_mode="floor")
    parts = []
    for j in range(matrix.mesh.size):
        pos = torch.nonzero(owner == j).flatten()
        if pos.numel():
            parts.append((j, pos, r[pos] - j * per))
    return parts


def ring_gather_rows(matrix: RowShardedMatrix, rows_by_shard: Sequence[Tensor]) -> List[Tensor]:
    """out[k][i] = matrix[rows_by_shard[k][i]] on shard k's card: each
    shard's slice asks for rows, and every card that owns some of them
    selects them in its block and copies them to the asking card, where
    they are written in place (an exact selection, no add: -0.0 and every
    other value keep their bits). Dispatched under the `collective` fault
    site; a retry repeats the selection, so it gives the same bits."""

    def gather() -> List[Tensor]:
        out = []
        for k, rows in enumerate(rows_by_shard):
            dev = matrix.mesh.devices[k]
            part = torch.zeros((int(rows.shape[0]), matrix.shape[1]), dtype=matrix.dtype, device=dev)
            for j, pos, local in _owned_parts(matrix, rows):
                block = matrix.blocks[j]
                part[pos.to(dev)] = block[local.to(block.device)].to(dev)
            out.append(part)
        return out

    return dispatch_collective(gather, label="ring_gather_rows")


def ring_scatter_rows(matrix: RowShardedMatrix, rows_by_shard: Sequence[Tensor],
                      values_by_shard: Sequence[Tensor]) -> RowShardedMatrix:
    """matrix[rows_by_shard[k]] = values_by_shard[k] for every shard k, in
    place: each slice's rows are copied to the card that owns them and
    written into its block. Rows written twice must carry equal values (the
    padding entities all write the pinned row, JAX mesh.py:459-476).
    Dispatched under the `collective` fault site; a retry writes the same
    values again."""

    def scatter() -> RowShardedMatrix:
        for rows, values in zip(rows_by_shard, values_by_shard):
            for j, pos, local in _owned_parts(matrix, rows):
                block = matrix.blocks[j]
                block[local.to(block.device)] = values[pos.to(values.device)].to(block.device)
        return matrix

    return dispatch_collective(scatter, label="ring_scatter_rows")


def ring_gather_wire_bytes(mesh: CardMesh, n_rows_padded: int, dim: int, itemsize: int = 4) -> int:
    """The reference's analytic wire bytes of one `ring_gather_rows` call:
    each of the S shards passes its (n_rows_padded / S, dim) block around
    the ring, S * the matrix's bytes."""
    return int(mesh.size) * int(n_rows_padded) * int(dim) * int(itemsize)


def ring_scatter_wire_bytes(mesh: CardMesh, n_updates_padded: int, dim: int, itemsize: int = 4) -> int:
    """The reference's analytic wire bytes of one `ring_scatter_rows` call:
    the (int32 rows, (., dim) values) payload rotates S steps."""
    return int(mesh.size) * int(n_updates_padded) * (4 + int(dim) * int(itemsize))


def lanes_in_place(blocks: EntityBlocks, lo: int, hi: int, pinned: int) -> EntityBlocks:
    """`blocks` with its shape kept and every lane outside [lo, hi) made a
    dummy (it gathers row 0 under mask 0 and writes the pinned row). A
    batched solve of it gives lanes lo..hi-1 the bits of the whole bucket's
    solve: its products and sums run at the whole bucket's shapes, so a
    library picks the same kernel, and a lane's path reads its own lane
    alone (its dummies' gradient is 0 from a zero start)."""
    live = torch.zeros(blocks.num_entities, dtype=torch.bool, device=blocks.gather.device)
    live[lo:hi] = True
    return EntityBlocks(torch.where(live[:, None], blocks.gather, 0),
                        torch.where(live[:, None], blocks.mask, 0.0),
                        torch.where(live, blocks.entity_rows, pinned))


class ShardedEntityBlocks:
    """One bucket over a CardMesh: its entities padded to a multiple of the
    shard count and cut into contiguous slices, `slices[k]` (an
    EntityBlocks) on `mesh.devices[k]`, whose rows the ring collectives
    move. Shard k solves `placed[k]` on its card: the bucket at its own
    shape with lanes `lanes[k]` = (first, count) live (`lanes_in_place`),
    the first `count` lanes of its slice; the slice's other lanes are the
    mesh's padding. `real_entities` is the bucket's own count."""

    def __init__(self, slices: Sequence[EntityBlocks], placed: Sequence[EntityBlocks],
                 lanes: Sequence[Tuple[int, int]], real_entities: int):
        self.slices = tuple(slices)
        self.placed = tuple(placed)
        self.lanes = tuple(lanes)
        self.real_entities = int(real_entities)

    @property
    def num_entities(self) -> int:
        """The padded count."""
        return sum(s.num_entities for s in self.slices)

    @property
    def capacity(self) -> int:
        return self.slices[0].capacity


@dataclasses.dataclass
class CardReplica:
    """What one card of a group reads to gather its slices' blocks: the
    sample data (the random effect's feature shard, labels and weights) and
    the Pearson feature mask, on that card. `rows`: on a card other than
    the dataset's, the sample rows its blocks gather (on the dataset's
    device), the only offsets a train sends it (`card_offsets`); None on
    the dataset's card, which reads the offsets themselves."""

    dataset: GameDataset
    feature_mask: Optional[Tensor]
    rows: Optional[Tensor] = None


def card_offsets(offsets: Tensor, replica: CardReplica) -> Tensor:
    """The residual offsets as `replica`'s card reads them: `offsets`
    themselves on the dataset's card, else a vector on that card holding
    them at the rows its blocks gather (copied exactly) and zeros at rows
    no block reads."""
    if replica.rows is None:
        return offsets
    dev = replica.dataset.labels.device
    out = torch.zeros(offsets.shape, dtype=offsets.dtype, device=dev)
    out[replica.rows.to(dev)] = offsets[replica.rows].to(dev)
    return out


def shard_random_effect_dataset(red: RandomEffectDataset, mesh: CardMesh, dataset: GameDataset, *,
                                replicate_sample_rows: bool = True) -> RandomEffectDataset:
    """`red` (built over `dataset`) with each bucket's entity axis over
    `mesh` (JAX mesh.py:547-620): the entity count padded to a multiple of
    the shard count with dummy entities that gather row 0 under mask 0 and
    write the pinned row, then cut into one contiguous slice a shard, each
    on its shard's card with its in-place block (`ShardedEntityBlocks`).
    The sample data stays replicated: every distinct card of the mesh gets
    the random effect's feature shard, the labels, the weights and the
    feature mask (`card_replicas`; the dataset's own card keeps the
    dataset), and `sample_entity_rows` stays whole on the dataset's card,
    where the coordinate scores. `replicate_sample_rows` False (the
    reference's batch-sharded sample rows, for sample-sharded scoring) has
    no counterpart: a group scores on its home card."""
    if not replicate_sample_rows:
        raise ValueError("a card group scores on its home card: its sample rows stay replicated "
                         "(replicate_sample_rows=True)")
    if red.owned_entities is not None or red.view is not None:
        raise ValueError("a random effect of one rank's rows cannot be sharded over cards")
    S, pinned = mesh.size, red.num_entities
    buckets = []
    reads: Dict[torch.device, List[Tensor]] = {}
    for b in red.buckets:
        e = b.num_entities
        rem = (-e) % S
        gather = torch.nn.functional.pad(b.gather, (0, 0, 0, rem))
        mask = torch.nn.functional.pad(b.mask, (0, 0, 0, rem))
        rows = torch.nn.functional.pad(b.entity_rows, (0, rem), value=pinned)
        per = (e + rem) // S
        slices, placed, lanes = [], [], []
        for k, d in enumerate(mesh.devices):
            lo, hi = k * per, (k + 1) * per
            slices.append(EntityBlocks(gather[lo:hi].to(d), mask[lo:hi].to(d), rows[lo:hi].to(d)))
            lanes.append((lo, max(0, min(hi, e) - lo)))
            p = lanes_in_place(b, lo, min(hi, e), pinned)
            reads.setdefault(d, []).append(p.gather.flatten())
            placed.append(EntityBlocks(p.gather.to(d), p.mask.to(d), p.entity_rows.to(d)))
        buckets.append(ShardedEntityBlocks(slices, placed, lanes, e))
    feats = dataset.shards[red.feature_shard]
    replicas = {}
    for dev in dict.fromkeys(mesh.devices):
        if dev == dataset.device:
            replicas[dev] = CardReplica(dataset, red.feature_mask)
            continue
        put = lambda a: None if a is None else a.to(dev)
        shard = (dataclasses.replace(feats, indices=put(feats.indices), values=put(feats.values))
                 if isinstance(feats, SparseFeatures) else put(feats))
        ds = GameDataset(shards={red.feature_shard: shard}, labels=put(dataset.labels),
                         offsets=put(dataset.offsets), weights=put(dataset.weights),
                         id_tags=dataset.id_tags)
        rows = torch.unique(torch.cat([r.to(dataset.device) for r in reads[dev]]))
        replicas[dev] = CardReplica(ds, put(red.feature_mask), rows)
    return dataclasses.replace(red, buckets=buckets, card_mesh=mesh, card_replicas=replicas)
