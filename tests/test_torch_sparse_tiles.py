"""The single-stream layout (row tiles, their column order, slabs) and an
emulation of the single-stream kernels' reduction order
(photon_ml_tpu_torch/csrc/sparse_glm.cu), held against the plain versions
and the JAX package's Pallas kernels in interpret mode.

The emulation lives here, not in the package: it walks the layout the way
the kernels do (slab by slab, tile by tile; a row's entries lane-strided
over 32 lanes then summed by a butterfly; a row longer than a tile
thread-strided over the 512 consumer threads; u by producer lane; each run
of one column in the tile's column order summed in order and added to the
slab's accumulator once; slabs added in order, in double), in float32.
X^T u's kernel rounds each term (val * u, or (val * val) * u) on its own
and adds the terms of a run in order; a row longer than a tile adds its
terms to the accumulator one by one."""

from __future__ import annotations

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data.bucketed import pack_bucketed
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import pallas_sparse
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.ops import losses, sparse_kernels

TOL = PORT_TOLERANCES["kernel_sums_f32"]["scale_rel"]
SHAPES = ("uniform", "hot_0.25", "hot_0.6", "empty_rows_cols", "long_rows", "ragged")
CONSUMERS = 512  # the fused kernel's consumer threads (Plan<true>::kConsumers)


def _shape(name: str, seed: int = 31):
    """(rows, cols, vals, n, dim, empty_rows, empty_cols) of one test matrix,
    duplicates merged away (the JAX pack keeps them apart)."""
    rng = np.random.default_rng(seed)
    empty_rows, empty_cols = np.zeros(0, np.int64), 0
    if name == "uniform" or name.startswith("hot_"):
        n, d, nnz = 6000, 260, 48000
        rows, cols = rng.integers(0, n, nnz), rng.integers(0, d, nnz)
        hot = int(nnz * float(name[4:])) if name.startswith("hot_") else 0
        cols[:hot] = rng.integers(0, 8, hot)  # the first 8 columns are hot
    elif name == "empty_rows_cols":
        n, d, nnz = 5003, 300, 30000
        live = np.arange(n)[np.arange(n) % 7 != 0]
        rows, cols = rng.choice(live, nnz), rng.integers(40, d, nnz)
        empty_rows, empty_cols = np.arange(0, n, 7), 40
    elif name == "long_rows":
        n, d = 3001, 5000
        rows, cols = rng.integers(0, n, 24000), rng.integers(25, d, 24000)
        keep = rows % 11 != 0
        rows, cols = rows[keep], cols[keep]
        for r, length in ((3, 2049), (1500, 4600), (2999, 2048)):  # two past TILE, one at it
            keep = rows != r
            rows = np.concatenate([rows[keep], np.full(length, r)])
            cols = np.concatenate([cols[keep], rng.choice(np.arange(25, d), length, replace=False)])
        empty_rows, empty_cols = np.setdiff1d(np.arange(0, n, 11), [3, 1500, 2999]), 25
    elif name == "ragged":  # short rows: tiles end at TILE_ROWS rows; n not a multiple of it
        n, d = 4099, 97
        lens = rng.integers(0, 3, n)
        rows, cols = np.repeat(np.arange(n), lens), rng.integers(0, d, int(lens.sum()))
        empty_rows = np.nonzero(lens == 0)[0]
    else:
        raise ValueError(name)
    _, first = np.unique(rows * d + cols, return_index=True)
    first = np.sort(first)
    vals = rng.normal(size=len(first)).astype(np.float32)
    rows, cols = rows[first], cols[first]
    empty_rows = np.setdiff1d(empty_rows, rows)
    return rows, cols, vals, n, d, empty_rows, empty_cols


def _layout(rows, cols, vals, n, d, n_slabs=None, csc=None):
    """The layout, cut into `n_slabs` slabs where given (the kernels launch one
    block per slab; a CUDA layout has one per multiprocessor)."""
    L = sparse_layout.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                               torch.from_numpy(vals), n, d, csc=csc)
    if n_slabs is None:
        return L
    return dataclasses.replace(L, slab_tile=sparse_layout.slab_table(L.tile_row, L.tile_ptr, n_slabs))


def _scale_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0 if ref.ndim == 0 else 1e-30))


# ---------------------------------------------------------------- the layout


@pytest.mark.parametrize("n_slabs", [1, 5, 132])
@pytest.mark.parametrize("name", SHAPES)
def test_layout_tiles_permutation_and_slabs(name, n_slabs):
    rows, cols, vals, n, d, _, _ = _shape(name)
    L = _layout(rows, cols, vals, n, d, n_slabs, csc=True)
    row_ptr, tile_row, tile_ptr = L.row_ptr.numpy(), L.tile_row.numpy(), L.tile_ptr.numpy()
    lens = np.diff(row_ptr)
    # Tiles start at row boundaries, cover every row once, in order.
    assert tile_row[0] == 0 and tile_row[-1] == n and np.all(np.diff(tile_row) >= 1)
    np.testing.assert_array_equal(tile_ptr, row_ptr[tile_row])
    t_rows, t_entries = np.diff(tile_row), np.diff(tile_ptr)
    assert t_rows.max() <= sparse_layout.TILE_ROWS
    over = t_entries > sparse_layout.TILE
    assert np.all(t_rows[over] == 1)  # only a lone long row exceeds TILE
    # Greedy: a tile ends only where its next row would break a limit.
    for t in range(L.n_tiles - 1):
        nxt = tile_row[t + 1]
        assert (t_rows[t] == sparse_layout.TILE_ROWS or over[t]
                or t_entries[t] + lens[nxt] > sparse_layout.TILE), t
    # Each tile's permutation is a stable sort by column covering each entry once.
    col_idx, perm = L.col_idx.numpy(), L.tile_perm.numpy().astype(np.int64) & 0xFFFF
    for t in range(L.n_tiles):
        e0, e1 = tile_ptr[t], tile_ptr[t + 1]
        pos = perm[e0:e1]
        if over[t]:
            np.testing.assert_array_equal(pos, np.arange(e1 - e0) & 0xFFFF)  # already column order
            continue
        assert np.array_equal(np.sort(pos), np.arange(e1 - e0))
        at = np.empty(e1 - e0, np.int64)
        at[pos] = np.arange(e1 - e0)  # CSR entry at each sorted position
        np.testing.assert_array_equal(at, np.argsort(col_idx[e0:e1], kind="stable"))
    # Slabs cover every tile in order, with about equal work.
    slab_tile = L.slab_tile.numpy()
    assert L.n_slabs == n_slabs and slab_tile[0] == 0 and slab_tile[-1] == L.n_tiles
    assert np.all(np.diff(slab_tile) >= 0)
    work = np.concatenate([[0], np.cumsum(t_entries + t_rows)])
    per_slab = np.diff(work[slab_tile])
    assert per_slab.max() <= work[-1] / n_slabs + (t_entries + t_rows).max()
    # A rebuild is identical.
    again = _layout(rows, cols, vals, n, d, n_slabs, csc=True)
    for f in ("row_ptr", "col_idx", "row_val", "tile_row", "tile_ptr", "tile_perm", "slab_tile",
              "col_ptr", "row_idx", "col_val", "chunk_ptr", "chunk_start"):
        assert torch.equal(getattr(L, f), getattr(again, f)), f


def test_layout_of_no_rows_has_no_tiles_and_empty_slabs():
    L = _layout(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32), 0, 5, 3)
    assert L.n_tiles == 0 and L.slab_tile.tolist() == [0, 0, 0, 0]
    assert sparse_layout.default_slabs(torch.device("cpu")) == sparse_layout.DEFAULT_SLABS


def test_routes_follow_dim_and_match_the_cuda_source():
    src = sparse_kernels.SOURCE.read_text()
    fused_max, matvec_max = map(int, re.search(
        r"kMaxDim = FUSED \? (\d+) : (\d+);", src).groups())
    assert (fused_max, matvec_max) == (sparse_kernels.FUSED_STREAM_MAX_DIM,
                                       sparse_kernels.MATVEC_STREAM_MAX_DIM)
    rmatvec_max = int(re.search(r"struct RmatvecPlan \{.*?kMaxDim = (\d+);", src, re.S).group(1))
    assert rmatvec_max == sparse_kernels.RMATVEC_STREAM_MAX_DIM
    # The layout holds the widths; it builds the CSC copy above the narrowest.
    assert sparse_layout.CSC_FROM_DIM == min(fused_max, matvec_max, rmatvec_max) + 1
    assert int(re.search(r"constexpr int kTile = (\d+);", src).group(1)) == sparse_layout.TILE
    assert int(re.search(r"constexpr int kTileRows = (\d+);", src).group(1)) == sparse_layout.TILE_ROWS
    ss, tp = sparse_kernels.SINGLE_STREAM, sparse_kernels.TWO_PASS
    assert sparse_kernels.fused_route(fused_max) == ss and sparse_kernels.fused_route(fused_max + 1) == tp
    assert sparse_kernels.matvec_route(matvec_max) == ss and sparse_kernels.matvec_route(matvec_max + 1) == tp
    assert sparse_kernels.rmatvec_route(rmatvec_max) == ss
    assert sparse_kernels.rmatvec_route(rmatvec_max + 1) == tp
    for route in (sparse_kernels.fused_route, sparse_kernels.matvec_route, sparse_kernels.rmatvec_route):
        assert route(16384) == ss  # the main path's width
        assert route(200003) == tp


def test_two_pass_entries_take_the_plain_version_on_cpu_without_counting():
    rows, cols, vals, n, d, _, _ = _shape("uniform")
    L = _layout(rows, cols, vals, n, d)
    w, y, off, wt = torch.randn(d), torch.rand(n).round(), torch.randn(n), torch.rand(n)
    before = dict(sparse_kernels.LAUNCHES)
    assert torch.equal(sparse_kernels.matvec_two_pass(L, w), sparse_kernels.matvec_plain(L, w))
    args = (losses.LOGISTIC, w, 0.1, L, y, off, wt)
    got = sparse_kernels.fused_value_gradient_sums_two_pass(*args)
    for g, r in zip(got, sparse_kernels.fused_value_gradient_sums_plain(*args)):
        assert torch.equal(g, r)
    assert sparse_kernels.LAUNCHES == before


@pytest.mark.parametrize("square", [False, True])
def test_rmatvec_two_pass_takes_the_plain_version_on_cpu_without_counting(square):
    rows, cols, vals, n, d, _, _ = _shape("hot_0.25")
    u = torch.randn(n)
    before = dict(sparse_kernels.LAUNCHES)
    for csc in (False, True):  # the CPU needs no CSC copy
        L = _layout(rows, cols, vals, n, d, csc=csc)
        got = sparse_kernels.rmatvec_two_pass(L, u, square)
        assert torch.equal(got, sparse_kernels.rmatvec_plain(L, u, square))
        assert torch.equal(got, sparse_kernels.rmatvec(L, u, square=square))
    assert sparse_kernels.LAUNCHES == before


# ------------------------------------------------------ the kernel's order


def _fma(a, b, c):
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _butterfly(x):
    """warp_sum: lanes on the last axis, xor-shuffle sums, lane 0's total."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = (x + x[..., lanes ^ o]).astype(np.float32)
    return x[..., 0]


def _strided(vals, w_cols, group, slot, width):
    """Sums of each group's products, lane-strided over `width` threads
    (slot = position in the group): one fma chain per thread, in order."""
    acc = np.zeros((group.max() + 1 if len(group) else 0, width), np.float32)
    for m in range(int(slot.max() // width) + 1 if len(slot) else 0):
        sel = slot // width == m
        g, lane = group[sel], slot[sel] % width
        acc[g, lane] = _fma(vals[sel], w_cols[sel], acc[g, lane])
    return acc


def _emulate(L, w, y=None, off=None, wt=None, shift=0.0, loss=None):
    """z (matvec), or (value, grad, sum_u, value over the empty rows) as the
    single-stream kernels compute them."""
    row_ptr, col_idx, val = L.row_ptr.numpy(), L.col_idx.numpy(), L.row_val.numpy()
    tile_row, tile_ptr = L.tile_row.numpy(), L.tile_ptr.numpy()
    perm = L.tile_perm.numpy().astype(np.int64) & 0xFFFF
    w = np.asarray(w, np.float32)
    lens = np.diff(row_ptr)
    row_of = np.repeat(np.arange(L.n_rows), lens)
    slot = np.arange(L.nnz) - row_ptr[row_of]
    z = _butterfly(_strided(val, w[col_idx], row_of, slot, 32)) if L.nnz else np.zeros(0)
    z = np.concatenate([z, np.zeros(L.n_rows - len(z), np.float32)]).astype(np.float32)
    for t in np.nonzero(np.diff(tile_ptr) > sparse_layout.TILE)[0]:  # long rows: 512 threads
        r, e0, e1 = tile_row[t], tile_ptr[t], tile_ptr[t + 1]
        th = _strided(val[e0:e1], w[col_idx[e0:e1]], np.zeros(e1 - e0, np.int64),
                      np.arange(e1 - e0), CONSUMERS)[0]
        per_warp = _butterfly(th.reshape(CONSUMERS // 32, 32))
        z[r] = np.float32(0.0)
        for p in per_warp:
            z[r] = np.float32(z[r] + p)
    if loss is None:
        return z
    zt = torch.from_numpy((z + off).astype(np.float32) + np.float32(shift))
    u = (torch.from_numpy(wt) * loss.d1(zt, torch.from_numpy(y))).numpy()
    lv = (torch.from_numpy(wt) * loss.loss(zt, torch.from_numpy(y))).numpy()
    slab_tile = L.slab_tile.numpy()
    grad, value, sum_u = np.zeros(L.dim), 0.0, 0.0
    for s in range(L.n_slabs):
        acc = np.zeros(L.dim, np.float32)
        lane_v, lane_u = np.zeros(32, np.float32), np.zeros(32, np.float32)
        long_v, long_u = np.float32(0), np.float32(0)
        for t in range(slab_tile[s], slab_tile[s + 1]):
            r0, r1, e0, e1 = tile_row[t], tile_row[t + 1], tile_ptr[t], tile_ptr[t + 1]
            if e1 - e0 > sparse_layout.TILE:
                long_v, long_u = np.float32(long_v + lv[r0]), np.float32(long_u + u[r0])
                acc[col_idx[e0:e1]] = (acc[col_idx[e0:e1]] + (val[e0:e1] * u[r0]).astype(np.float32))
                continue
            for i in range(r1 - r0):  # the producer: lane i % 32, in tile order
                lane_v[i % 32] = np.float32(lane_v[i % 32] + lv[r0 + i])
                lane_u[i % 32] = np.float32(lane_u[i % 32] + u[r0 + i])
            at = np.empty(e1 - e0, np.int64)
            at[perm[e0:e1]] = np.arange(e0, e1)  # column order
            c, pv, pu = col_idx[at], val[at], u[row_of[at]]
            start = 0
            while start < len(at):  # each run, in order, added once
                end = start + 1
                run = np.float32(pv[start] * pu[start])
                while end < len(at) and c[end] == c[start]:
                    run = _fma(pv[end], pu[end], run)
                    end += 1
                acc[c[start]] = np.float32(acc[c[start]] + run)
                start = end
        grad += acc.astype(np.float64)
        value += float(np.float32(_butterfly(lane_v) + long_v))
        sum_u += float(np.float32(_butterfly(lane_u) + long_u))
    empty = lens == 0
    return (np.float32(value), grad.astype(np.float32), np.float32(sum_u),
            float(lv[empty].astype(np.float64).sum()))


def _emulate_rmatvec(L, u, square=False):
    """g = X^T u (or (X o X)^T u) as the single-stream X^T u kernel computes it."""
    row_ptr, col_idx, val = L.row_ptr.numpy(), L.col_idx.numpy(), L.row_val.numpy()
    tile_ptr, slab_tile = L.tile_ptr.numpy(), L.slab_tile.numpy()
    perm = L.tile_perm.numpy().astype(np.int64) & 0xFFFF
    u = np.asarray(u, np.float32)
    row_of = np.repeat(np.arange(L.n_rows), np.diff(row_ptr))
    term = (val * val if square else val) * u[row_of]  # float32, each product rounded
    g = np.zeros(L.dim)
    for s in range(L.n_slabs):
        acc = np.zeros(L.dim, np.float32)
        for t in range(slab_tile[s], slab_tile[s + 1]):
            e0, e1 = tile_ptr[t], tile_ptr[t + 1]
            if e1 - e0 > sparse_layout.TILE:  # one row, its terms added one by one
                acc[col_idx[e0:e1]] = acc[col_idx[e0:e1]] + term[e0:e1]
                continue
            at = np.empty(e1 - e0, np.int64)
            at[perm[e0:e1]] = np.arange(e0, e1)  # column order
            c, p = col_idx[at], term[at]
            start = 0
            while start < len(at):  # each run, in order, added once
                end, run = start + 1, p[start]
                while end < len(at) and c[end] == c[start]:
                    run = np.float32(run + p[end])
                    end += 1
                acc[c[start]] = np.float32(acc[c[start]] + run)
                start = end
        g += acc.astype(np.float64)
    return g.astype(np.float32)


@pytest.fixture(scope="module", params=SHAPES)
def case(request):
    rows, cols, vals, n, d, empty_rows, empty_cols = _shape(request.param)
    rng = np.random.default_rng(7)
    return dict(name=request.param, layout=_layout(rows, cols, vals, n, d, 5),
                bf=pack_bucketed(rows, cols, vals, n, d), rng=rng, n=n, d=d,
                empty_rows=empty_rows, empty_cols=empty_cols)


def test_emulated_matvec_matches_plain_and_pallas(case):
    L, d = case["layout"], case["d"]
    w = case["rng"].normal(size=d).astype(np.float32)
    z = _emulate(L, w)
    assert _scale_rel(z, sparse_kernels.matvec_plain(L, torch.from_numpy(w))) <= TOL
    assert _scale_rel(z, pallas_sparse.matvec(case["bf"], jnp.asarray(w), interpret=True)) <= TOL
    assert np.all(z[case["empty_rows"]] == 0.0)


@pytest.mark.parametrize("loss", ["logistic", "poisson"])
def test_emulated_fused_sums_match_plain_and_pallas(case, loss):
    L, n, d, rng = case["layout"], case["n"], case["d"], case["rng"]
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(1.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.1).astype(np.float32)
    off = (rng.normal(size=n) * 0.2).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    shift = 0.03
    port_loss = getattr(losses, loss.upper())
    value, grad, sum_u, empty_value = _emulate(L, w, y, off, wt, shift, port_loss)
    plain = sparse_kernels.fused_value_gradient_sums_plain(
        port_loss, torch.from_numpy(w), shift, L, torch.from_numpy(y), torch.from_numpy(off),
        torch.from_numpy(wt))
    ref = pallas_sparse.fused_value_gradient_sums(
        getattr(jax_losses, loss.upper()), jnp.asarray(w), jnp.asarray(shift, jnp.float32),
        case["bf"], jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt), interpret=True)
    for want in (plain, ref):
        assert _scale_rel(value, want[0]) <= TOL
        assert _scale_rel(grad, want[1]) <= TOL
        assert _scale_rel(sum_u, want[2]) <= TOL
    assert np.all(grad[:case["empty_cols"]] == 0.0)
    if len(case["empty_rows"]):  # empty rows count in the value: without them it misses
        assert _scale_rel(value - empty_value, plain[0]) > TOL


@pytest.mark.parametrize("square", [False, True])
def test_emulated_rmatvec_matches_plain_and_pallas(case, square):
    L, n = case["layout"], case["n"]
    u = case["rng"].normal(size=n).astype(np.float32)
    g = _emulate_rmatvec(L, u, square)
    assert _scale_rel(g, sparse_kernels.rmatvec_plain(L, torch.from_numpy(u), square)) <= TOL
    ref = pallas_sparse.rmatvec(case["bf"], jnp.asarray(u), interpret=True, square=square)
    assert _scale_rel(g, ref) <= TOL
    assert np.all(g[:case["empty_cols"]] == 0.0)
    assert np.all(g[np.bincount(L.col_idx.numpy(), minlength=L.dim) == 0] == 0.0)
