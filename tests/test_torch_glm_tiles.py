"""An emulation of the dense kernels' reduction order on their rows and
wide routes (photon_ml_tpu_torch/csrc/glm_fused.cu, glm_rows_kernel and
glm_wide_kernel), held against the plain versions and the JAX package's
Pallas kernels in interpret mode.

The emulation lives here, not in the package. It walks the rows the way
the kernel does, in float32: a lane holds K 16-byte vectors of a row
(vector j = lane + 32 k, 8 bf16 or 4 f32 columns each) and w, v in the same
order, and sums its columns' products in order; a butterfly over the 32
lanes (xor 16, 8, 4, 2, 1) gives z and q; tiles of R rows go to the blocks
in turn (tile t to block t % blocks) and a tile's row r to consumer warp
r % warps, which adds u x (or r x) into its lanes' gradient in row order;
a block adds its warps in warp order, and the blocks are added in block
order in double. On the wide route consumer thread t of 512 owns columns
t, t + 512, ... and sums its products of a row in that order; a butterfly
over each warp's lanes, then the 16 warps in order, give z and q; thread r
computes row r's u (or r) and keeps its value and sum; every thread adds
u x into its columns in row order. The constants below are the kernel's
(RowsPlan, kStageX, kMaxRows, kRowsMaxCols, and the kWide* ones)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import pallas_glm
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.ops import glm_kernels, losses

TOL = PORT_TOLERANCES["kernel_vs_plain"]["scale_rel"]
STAGE_X = 32768  # kStageX: bytes of X rows a stage takes
MAX_ROWS = 128  # kMaxRows
ROWS_MAX_COLS = 1024  # kRowsMaxCols: wider rows take the wide route
MAX_BLOCKS = 7  # the card launches one block an SM; a few here
WIDE_STAGE_X = 65536  # kWideStageX
WIDE_MAX_ROWS = 64  # kWideMaxRows
WIDE_CONSUMERS = 512  # kWideConsumers
WIDE_MAX_COLS = 16384  # kWideMaxCols: wider rows take the chunked route

PAIRS = [
    (losses.LOGISTIC, jax_losses.LOGISTIC),
    (losses.SQUARED, jax_losses.SQUARED),
    (losses.POISSON, jax_losses.POISSON),
    (losses.SMOOTHED_HINGE, jax_losses.SMOOTHED_HINGE),
]
IDS = [p[0].name for p in PAIRS]
# (d, dtype): the main path's width, an odd width (rows not on 16 bytes:
# element loads), the widest off-path check, and examples/run_glmix.sh's
# a1a width with its intercept in both dtypes.
SHAPES = [(512, "bf16"), (517, "bf16"), (1000, "f32"), (124, "bf16"), (124, "f32")]
SHAPE_IDS = [f"d{d}_{dt}" for d, dt in SHAPES]
WIDE_SHAPES = [(1536, "bf16"), (2100, "f32")]  # the card's wide-route checks
WIDE_IDS = [f"d{d}_{dt}" for d, dt in WIDE_SHAPES]


def plan(d: int, dtype: str):
    """(K, columns a vector, consumer warps, rows a tile) of the rows route."""
    es = 2 if dtype == "bf16" else 4
    per = 16 // es
    vectors = -(-d // per)
    k = 1
    while 32 * k < vectors:
        k *= 2
    warps = 16 if k * per <= 16 else 8
    return k, per, warps, min(MAX_ROWS, STAGE_X // (d * es))


def wide_plan(d: int, dtype: str):
    """(columns a thread, rows a tile) of the wide route."""
    es = 2 if dtype == "bf16" else 4
    j = 4
    while WIDE_CONSUMERS * j < d:
        j *= 2
    return j, min(WIDE_MAX_ROWS, WIDE_STAGE_X // (d * es))


def _problem(seed, n, d, dtype, poisson):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32) * (0.1 if poisson else 1.0)
    if dtype == "bf16":
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()  # what the card stores
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    off = (rng.normal(size=n) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w = (rng.normal(size=d) * 0.05).astype(np.float32)
    v = rng.normal(size=d).astype(np.float32)
    return X, y, off, wt, w, v


def emulate(loss, X, y, off, wt, w, v, shift, v_shift, dtype, blocks, hvp):
    """The rows route's sums in its order: (value, grad_raw, sum_u), or
    (hv_raw, sum_r) with hvp."""
    f32 = np.float32
    n, d = X.shape
    k, per, warps, rows = plan(d, dtype)
    cols = k * per
    lane_cols = ((np.arange(32)[:, None, None] + 32 * np.arange(k)[None, :, None]) * per
                 + np.arange(per)[None, None, :]).reshape(32, cols)
    pad = 32 * cols
    Xp = np.zeros((n, pad), f32)
    Xp[:, :d] = X
    Xl = Xp[:, lane_cols]  # (n, lane, the lane's columns in its order)
    wl = np.zeros(pad, f32)
    wl[:d] = w
    vl = np.zeros(pad, f32)
    vl[:d] = v
    wl, vl = wl[lane_cols], vl[lane_cols]
    pz = np.zeros((n, 32), f32)
    pq = np.zeros((n, 32), f32)
    for j in range(cols):
        pz = pz + Xl[:, :, j] * wl[:, j]
        pq = pq + Xl[:, :, j] * vl[:, j]
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        pz = pz + pz[:, lanes ^ o]
        pq = pq + pq[:, lanes ^ o]
    z = torch.from_numpy((pz[:, 0] + off) + f32(shift))
    yt, wtt = torch.from_numpy(y), torch.from_numpy(wt)
    if hvp:
        coef = (wtt * loss.d2(z, yt) * torch.from_numpy(pq[:, 0] + f32(v_shift))).numpy()
        value = np.zeros(n, f32)
    else:
        coef = (wtt * loss.d1(z, yt)).numpy()
        value = (wtt * loss.loss(z, yt)).numpy()
    # Consumer warp (block, warp) of each row; its rows in row order.
    i = np.arange(n)
    group = ((i // rows) % blocks) * warps + (i % rows) % warps
    order = np.lexsort((i, group))
    g_sorted = group[order]
    starts = np.searchsorted(g_sorted, np.arange(blocks * warps))
    rank = np.arange(n) - starts[g_sorted]
    acc = np.zeros((blocks * warps, 32, cols), f32)
    acc_value = np.zeros(blocks * warps, f32)
    acc_coef = np.zeros(blocks * warps, f32)
    for m in range(int(rank.max()) + 1 if n else 0):
        sel = order[rank == m]
        gs = group[sel]
        acc[gs] = acc[gs] + Xl[sel] * coef[sel][:, None, None]
        acc_value[gs] = acc_value[gs] + value[sel]
        acc_coef[gs] = acc_coef[gs] + coef[sel]
    grad = np.zeros((blocks, warps, pad), f32)
    grad[:, :, lane_cols.reshape(-1)] = acc.reshape(blocks, warps, 32 * cols)
    block_grad = grad[:, 0, :d].copy()
    block_value = acc_value.reshape(blocks, warps)[:, 0].copy()
    block_coef = acc_coef.reshape(blocks, warps)[:, 0].copy()
    for wp in range(1, warps):
        block_grad = block_grad + grad[:, wp, :d]
        block_value = block_value + acc_value.reshape(blocks, warps)[:, wp]
        block_coef = block_coef + acc_coef.reshape(blocks, warps)[:, wp]
    total = lambda a: np.add.reduce(a.astype(np.float64), axis=0).astype(f32)
    if hvp:
        return total(block_grad), total(block_coef)
    return total(block_value), total(block_grad), total(block_coef)


def emulate_wide(loss, X, y, off, wt, w, v, shift, v_shift, dtype, blocks, hvp):
    """The wide route's sums in its order, as `emulate`."""
    f32 = np.float32
    n, d = X.shape
    j_cols, rows = wide_plan(d, dtype)
    pad = WIDE_CONSUMERS * j_cols
    Xp = np.zeros((n, pad), f32)
    Xp[:, :d] = X
    Xt = Xp.reshape(n, j_cols, WIDE_CONSUMERS)  # [row, j, thread]: column t + 512 j
    wl = np.zeros(pad, f32)
    wl[:d] = w
    vl = np.zeros(pad, f32)
    vl[:d] = v
    wl, vl = wl.reshape(j_cols, WIDE_CONSUMERS), vl.reshape(j_cols, WIDE_CONSUMERS)
    pz = np.zeros((n, WIDE_CONSUMERS), f32)
    pq = np.zeros((n, WIDE_CONSUMERS), f32)
    for j in range(j_cols):
        pz = pz + Xt[:, j, :] * wl[j]
        pq = pq + Xt[:, j, :] * vl[j]
    lanes = np.arange(WIDE_CONSUMERS)
    for o in (16, 8, 4, 2, 1):  # within each warp: lane ^ o stays in the warp
        pz = pz + pz[:, lanes ^ o]
        pq = pq + pq[:, lanes ^ o]
    z, q = pz[:, 0].copy(), pq[:, 0].copy()
    for wp in range(1, WIDE_CONSUMERS // 32):
        z = z + pz[:, 32 * wp]
        q = q + pq[:, 32 * wp]
    zt = torch.from_numpy((z + off) + f32(shift))
    yt, wtt = torch.from_numpy(y), torch.from_numpy(wt)
    if hvp:
        coef = (wtt * loss.d2(zt, yt) * torch.from_numpy(q + f32(v_shift))).numpy()
        value = np.zeros(n, f32)
    else:
        coef = (wtt * loss.d1(zt, yt)).numpy()
        value = (wtt * loss.loss(zt, yt)).numpy()
    i = np.arange(n)
    block = (i // rows) % blocks
    grad = np.zeros((blocks, j_cols, WIDE_CONSUMERS), f32)
    acc_value = np.zeros((blocks, WIDE_MAX_ROWS), f32)  # thread r: row r of each tile
    acc_coef = np.zeros((blocks, WIDE_MAX_ROWS), f32)
    for b in range(blocks):
        for r in np.nonzero(block == b)[0]:  # the block's rows in row order
            grad[b] = grad[b] + Xt[r] * coef[r]
            acc_value[b, r % rows] = acc_value[b, r % rows] + value[r]
            acc_coef[b, r % rows] = acc_coef[b, r % rows] + coef[r]
    block_value, block_coef = acc_value[:, 0].copy(), acc_coef[:, 0].copy()
    for t in range(1, min(rows, WIDE_MAX_ROWS)):
        block_value = block_value + acc_value[:, t]
        block_coef = block_coef + acc_coef[:, t]
    block_grad = grad.reshape(blocks, pad)[:, :d]
    total = lambda a: np.add.reduce(a.astype(np.float64), axis=0).astype(f32)
    if hvp:
        return total(block_grad), total(block_coef)
    return total(block_value), total(block_grad), total(block_coef)


def _scale_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(float(np.max(np.abs(ref))), 1.0 if ref.ndim == 0 else 1e-30)
    return float(np.max(np.abs(got - ref))) / scale


def _case(shape, ragged, loss, seed):
    d, dtype = shape
    rows = plan(d, dtype)[3] if d <= ROWS_MAX_COLS else wide_plan(d, dtype)[1]
    n = 24 * rows + (rows // 2 + 1 if ragged else 0)
    arrays = _problem(seed, n, d, dtype, loss.name == "poisson")
    blocks = min(-(-n // rows), MAX_BLOCKS)
    return arrays, blocks


def _torch_args(X, y, off, wt, w, v, dtype):
    Xt = torch.from_numpy(X).to(torch.bfloat16) if dtype == "bf16" else torch.from_numpy(X)
    return (Xt,) + tuple(torch.from_numpy(a) for a in (y, off, wt, w, v))


def test_plan_matches_the_kernel_constants():
    """The route and tile rows the emulation assumes, at the shapes the card
    checks: the main path's 512 bf16 takes 32 rows a tile and two vectors a
    lane; rows up to 1,024 wide take the rows route in both dtypes."""
    assert plan(512, "bf16") == (2, 8, 16, 32)
    assert plan(1000, "f32") == (8, 4, 8, 8)
    assert plan(124, "bf16") == (1, 8, 16, 128)
    assert plan(ROWS_MAX_COLS, "bf16")[0] == 4 and plan(ROWS_MAX_COLS, "f32")[0] == 8
    assert wide_plan(ROWS_MAX_COLS + 1, "bf16") == (4, 31)
    assert wide_plan(2100, "f32") == (8, 7)
    assert wide_plan(WIDE_MAX_COLS, "f32") == (32, 1)  # a stage holds one widest f32 row


@pytest.mark.parametrize("ragged", [False, True], ids=["whole_tiles", "ragged"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_hvp_order_matches_plain_and_pallas(pair, shape, ragged):
    port_loss, jax_loss = pair
    (X, y, off, wt, w, v), blocks = _case(shape, ragged, port_loss, seed=5)
    shift, v_shift = -0.05, 0.2
    got = emulate(port_loss, X, y, off, wt, w, v, shift, v_shift, shape[1], blocks, hvp=True)
    Xt, yt, offt, wtt, wt_, vt = _torch_args(X, y, off, wt, w, v, shape[1])
    plain = glm_kernels.hessian_vector_sums_plain(port_loss, wt_, shift, vt, v_shift, Xt, yt, offt, wtt)
    Xj = jnp.asarray(X).astype(jnp.bfloat16) if shape[1] == "bf16" else jnp.asarray(X)
    ref = pallas_glm.hessian_vector_sums(
        jax_loss, jnp.asarray(w), jnp.float32(shift), jnp.asarray(v), jnp.float32(v_shift),
        Xj, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt), interpret=True,
    )
    for g, p, r in zip(got, plain, ref):
        assert _scale_rel(g, p.numpy()) <= TOL
        assert _scale_rel(g, np.asarray(r)) <= TOL


@pytest.mark.parametrize("ragged", [False, True], ids=["whole_tiles", "ragged"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_value_grad_order_matches_plain(pair, shape, ragged):
    """Kernel #1 runs on the same template (HVP = false)."""
    port_loss, _ = pair
    (X, y, off, wt, w, v), blocks = _case(shape, ragged, port_loss, seed=6)
    got = emulate(port_loss, X, y, off, wt, w, v, 0.07, 0.0, shape[1], blocks, hvp=False)
    Xt, yt, offt, wtt, wt_, _ = _torch_args(X, y, off, wt, w, v, shape[1])
    plain = glm_kernels.value_gradient_sums_plain(port_loss, wt_, 0.07, Xt, yt, offt, wtt)
    for g, p in zip(got, plain):
        assert _scale_rel(g, p.numpy()) <= TOL


def test_emulation_sees_a_wrong_lane_order():
    """The emulation is not blind to its own order: with w's lane slices
    rotated by one lane, z (and so the sums) change past the tolerance."""
    shape = (512, "bf16")
    (X, y, off, wt, w, v), blocks = _case(shape, False, losses.LOGISTIC, seed=7)
    k, per, _, _ = plan(*shape)
    w_bad = np.roll(w.reshape(k, 32, per), 1, axis=1).reshape(-1)
    got = emulate(losses.LOGISTIC, X, y, off, wt, w_bad, v, 0.0, 0.0, shape[1], blocks, hvp=True)
    Xt, yt, offt, wtt, wt_, vt = _torch_args(X, y, off, wt, w, v, shape[1])
    plain = glm_kernels.hessian_vector_sums_plain(losses.LOGISTIC, wt_, 0.0, vt, 0.0, Xt, yt, offt, wtt)
    assert _scale_rel(got[0], plain[0].numpy()) > TOL


@pytest.mark.parametrize("ragged", [False, True], ids=["whole_tiles", "ragged"])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=WIDE_IDS)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_wide_hvp_order_matches_plain_and_pallas(pair, shape, ragged):
    port_loss, jax_loss = pair
    (X, y, off, wt, w, v), blocks = _case(shape, ragged, port_loss, seed=8)
    shift, v_shift = -0.05, 0.2
    got = emulate_wide(port_loss, X, y, off, wt, w, v, shift, v_shift, shape[1], blocks, hvp=True)
    Xt, yt, offt, wtt, wt_, vt = _torch_args(X, y, off, wt, w, v, shape[1])
    plain = glm_kernels.hessian_vector_sums_plain(port_loss, wt_, shift, vt, v_shift, Xt, yt, offt, wtt)
    Xj = jnp.asarray(X).astype(jnp.bfloat16) if shape[1] == "bf16" else jnp.asarray(X)
    ref = pallas_glm.hessian_vector_sums(
        jax_loss, jnp.asarray(w), jnp.float32(shift), jnp.asarray(v), jnp.float32(v_shift),
        Xj, jnp.asarray(y), jnp.asarray(off), jnp.asarray(wt), interpret=True,
    )
    for g, p, r in zip(got, plain, ref):
        assert _scale_rel(g, p.numpy()) <= TOL
        assert _scale_rel(g, np.asarray(r)) <= TOL


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=WIDE_IDS)
@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_wide_value_grad_order_matches_plain(pair, shape):
    port_loss, _ = pair
    (X, y, off, wt, w, v), blocks = _case(shape, True, port_loss, seed=9)
    got = emulate_wide(port_loss, X, y, off, wt, w, v, 0.07, 0.0, shape[1], blocks, hvp=False)
    Xt, yt, offt, wtt, wt_, _ = _torch_args(X, y, off, wt, w, v, shape[1])
    plain = glm_kernels.value_gradient_sums_plain(port_loss, wt_, 0.07, Xt, yt, offt, wtt)
    for g, p in zip(got, plain):
        assert _scale_rel(g, p.numpy()) <= TOL
