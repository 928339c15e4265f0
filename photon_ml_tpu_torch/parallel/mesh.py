"""Ranks of torch.distributed: the mesh, its exact collectives, and who owns which rows.

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
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import os
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
