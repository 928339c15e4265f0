"""The sparse kernels' plain versions against the JAX package's Pallas
kernels (interpret mode) on the same COO matrix; the CSR/CSC layout build,
with the CSC copy only where it is asked for or a route may read it; the
ELL container and its host packer against the JAX package's."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_ml_tpu.data import containers as jax_containers
from photon_ml_tpu.data.bucketed import pack_bucketed
from photon_ml_tpu.ops import losses as jax_losses
from photon_ml_tpu.ops import pallas_sparse
from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.data import sparse_layout
from photon_ml_tpu_torch.data.containers import SparseFeatures, pack_csr_to_ell
from photon_ml_tpu_torch.ops import cuda_build, losses, sparse_kernels

TOL = PORT_TOLERANCES["kernel_sums_f32"]
N, D, NNZ = 6000, 260, 48000
HOT_FRACTIONS = [0.0, 0.25, 0.6]


def _coo(hot_fraction, seed=21):
    """Random COO triplets; a `hot_fraction` of the entries fall on the first
    8 columns (one 128-wide bucket), which spills the JAX layout into its
    level 2 and COO tail. Duplicate (row, col) pairs are merged away: the
    JAX pack keeps them as separate entries, so its squared product would
    square each one, where the port's layout sums them first (checked by
    the layout tests below)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, N, size=NNZ)
    cols = rng.integers(0, D, size=NNZ)
    hot = int(NNZ * hot_fraction)
    cols[:hot] = rng.integers(0, 8, size=hot)
    _, first = np.unique(rows * D + cols, return_index=True)
    vals = rng.normal(size=NNZ).astype(np.float32)
    return rows[first], cols[first], vals[first], rng


def _scale_rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1.0 if ref.ndim == 0 else 1e-30))


@pytest.fixture(scope="module", params=HOT_FRACTIONS)
def pair(request):
    rows, cols, vals, rng = _coo(request.param)
    bf = pack_bucketed(rows, cols, vals, N, D)
    if request.param:
        assert bf.density_report()["level1_fraction"] < 1.0  # level 2 / COO engaged
    layout = sparse_layout.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                                    torch.from_numpy(vals), N, D)
    return dict(hot=request.param, bf=bf, layout=layout, rng=rng)


def test_matvec_and_rmatvec_match_pallas(pair):
    rng, bf, layout = pair["rng"], pair["bf"], pair["layout"]
    w = rng.normal(size=D).astype(np.float32)
    u = rng.normal(size=N).astype(np.float32)
    z = sparse_kernels.matvec(layout, torch.from_numpy(w))
    assert _scale_rel(z, pallas_sparse.matvec(bf, jnp.asarray(w), interpret=True)) <= TOL["scale_rel"]
    for square in (False, True):
        g = sparse_kernels.rmatvec(layout, torch.from_numpy(u), square=square)
        ref = pallas_sparse.rmatvec(bf, jnp.asarray(u), interpret=True, square=square)
        assert _scale_rel(g, ref) <= TOL["scale_rel"], square


@pytest.mark.parametrize(
    "hot, loss",
    [(0.25, name) for name in sorted(losses.LOSS_IDS)]
    + [(0.0, "logistic"), (0.6, "logistic")],
)
def test_fused_sums_match_pallas(hot, loss):
    rows, cols, vals, rng = _coo(hot)
    bf = pack_bucketed(rows, cols, vals, N, D)
    layout = sparse_layout.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                                    torch.from_numpy(vals), N, D)
    y = (rng.uniform(size=N) > 0.5).astype(np.float32)
    if loss == "poisson":
        y = rng.poisson(1.0, size=N).astype(np.float32)
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    off = (rng.normal(size=N) * 0.01).astype(np.float32)
    wt = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    shift = 0.03
    ref = pallas_sparse.fused_value_gradient_sums(
        getattr(jax_losses, loss.upper()),
        jnp.asarray(w), jnp.asarray(shift, jnp.float32), bf, jnp.asarray(y), jnp.asarray(off),
        jnp.asarray(wt), interpret=True,
    )
    port_loss = getattr(losses, loss.upper())
    got = sparse_kernels.fused_value_gradient_sums(
        port_loss, torch.from_numpy(w), shift, layout, torch.from_numpy(y),
        torch.from_numpy(off), torch.from_numpy(wt),
    )
    for g, r in zip(got, ref):
        assert _scale_rel(g, r) <= TOL["scale_rel"]


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rows, cols, vals, rng = _coo(0.0)
    layout = sparse_layout.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                                    torch.from_numpy(vals), N, D)
    w, u = torch.randn(D), torch.randn(N)
    before = dict(sparse_kernels.LAUNCHES)
    assert torch.equal(sparse_kernels.matvec(layout, w), sparse_kernels.matvec_plain(layout, w))
    assert torch.equal(sparse_kernels.rmatvec(layout, u), sparse_kernels.rmatvec_plain(layout, u))
    assert sparse_kernels.LAUNCHES == before


@pytest.mark.parametrize("bad", ["w_len", "w_f64", "u_len", "labels_f64", "meta"])
def test_wrappers_reject_bad_inputs(bad):
    layout = sparse_layout.from_coo(torch.tensor([0, 1]), torch.tensor([2, 3]),
                                    torch.tensor([1.0, 2.0]), 4, 5)
    w, u, y = torch.zeros(5), torch.zeros(4), torch.zeros(4)
    with pytest.raises((ValueError, TypeError)):
        if bad == "w_len":
            sparse_kernels.matvec(layout, torch.zeros(4))
        elif bad == "w_f64":
            sparse_kernels.matvec(layout, w.double())
        elif bad == "u_len":
            sparse_kernels.rmatvec(layout, torch.zeros(5))
        elif bad == "labels_f64":
            sparse_kernels.fused_value_gradient_sums(losses.LOGISTIC, w, 0.0, layout, y.double(), u, u)
        else:
            sparse_kernels.rmatvec(layout, u.to("meta"))


def test_sparse_library_is_named_by_its_sources_and_built_under_the_package():
    path = cuda_build.library_path(sparse_kernels.SOURCE)
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libsparse_glm-")
    assert sparse_kernels.SOURCE.parent == cuda_build.CSRC_DIR
    # The shared header is part of the name: both libraries rebuild when it changes.
    assert (cuda_build.CSRC_DIR / "glm_losses.cuh").exists()
    assert '#include "glm_losses.cuh"' in sparse_kernels.SOURCE.read_text()


# ------------------------------------------------------------------- the layout


def _dense(rows, cols, vals, n, d):
    M = np.zeros((n, d), np.float64)
    np.add.at(M, (rows, cols), np.asarray(vals, np.float64))
    return M


def test_layout_drops_padding_sums_duplicates_and_keeps_empty_rows_and_columns_zero():
    # Row 1 and row 4 are all padding; row 0 holds (0, 2) three times; column 0
    # is only ever a padding target; columns 5 and 6 are empty.
    idx = np.array([[2, 2, 3, 2], [0, 0, 0, 0], [1, 4, 0, 0], [3, 1, 4, 2], [0, 0, 0, 0]], np.int32)
    val = np.array([[1.0, 2.0, 5.0, 0.5], [0, 0, 0, 0], [3.0, -1.0, 0, 0],
                    [4.0, 2.0, 1.0, -2.0], [0, 0, 0, 0]], np.float32)
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), 7)
    L = sparse_layout.from_ell(sf, csc=True)
    assert L.nnz == 2 + 2 + 4  # padding dropped, the three (0, 2) entries merged into one
    assert L.row_ptr.tolist() == [0, 2, 2, 4, 8, 8]
    assert L.col_idx[:2].tolist() == [2, 3] and L.row_val[:2].tolist() == [3.5, 5.0]
    assert (L.col_ptr[1:] - L.col_ptr[:-1]).tolist() == [0, 2, 2, 2, 2, 0, 0]
    assert L.row_idx.tolist() == [2, 3, 0, 3, 0, 3, 2, 3]  # rows ascend within each column
    M = _dense(np.repeat(np.arange(5), 4), idx.ravel(), val.ravel(), 5, 7)
    w, u = torch.randn(7), torch.randn(5)
    z = sparse_kernels.matvec(L, w)
    g = sparse_kernels.rmatvec(L, u)
    g2 = sparse_kernels.rmatvec(L, u, square=True)
    np.testing.assert_allclose(z.numpy(), M @ w.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), M.T @ u.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), (M * M).T @ u.numpy(), rtol=1e-6, atol=1e-6)
    assert z[1] == 0.0 and z[4] == 0.0
    assert g[0] == 0.0 and g[5] == 0.0 and g[6] == 0.0
    assert torch.equal(L.chunk_ptr, torch.tensor([0, 0, 1, 2, 3, 4, 4, 4]))


def test_layout_cuts_hot_columns_into_chunks_that_never_straddle_a_column():
    rng = np.random.default_rng(5)
    n, d = 3000, 40
    rows = np.arange(n).repeat(2)
    cols = np.where(np.arange(2 * n) % 2 == 0, 7, rng.integers(0, d, 2 * n))  # column 7 is hot
    vals = rng.normal(size=2 * n).astype(np.float32)
    L = sparse_layout.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                               torch.from_numpy(vals), n, d, csc=True)
    counts = (L.col_ptr[1:] - L.col_ptr[:-1]).numpy()
    per_col = (L.chunk_ptr[1:] - L.chunk_ptr[:-1]).numpy()
    assert counts[7] > 5 * sparse_layout.CHUNK
    np.testing.assert_array_equal(per_col, -(-counts // sparse_layout.CHUNK))
    start = L.chunk_start.numpy()
    assert start[0] == 0 and start[-1] == L.nnz
    assert np.all(np.diff(start) >= 1) and np.all(np.diff(start) <= sparse_layout.CHUNK)
    col_ptr, chunk_ptr = L.col_ptr.numpy(), L.chunk_ptr.numpy()
    for c in np.nonzero(counts)[0]:  # a column's chunks cover exactly its entries
        assert start[chunk_ptr[c]] == col_ptr[c] and start[chunk_ptr[c + 1]] == col_ptr[c + 1]
    u = rng.normal(size=n).astype(np.float32)
    M = _dense(rows, cols, vals, n, d)
    np.testing.assert_allclose(sparse_kernels.rmatvec(L, torch.from_numpy(u)).numpy(), M.T @ u,
                               rtol=1e-5, atol=1e-4)


CSC_FIELDS = ("col_ptr", "row_idx", "col_val", "chunk_ptr", "chunk_start")


@pytest.mark.parametrize("csc", [None, True, False])
@pytest.mark.parametrize("wide", [False, True])
def test_layout_keeps_the_csc_copy_only_where_asked_or_needed(csc, wide):
    rng = np.random.default_rng(13)
    n = 500
    d = sparse_layout.CSC_FROM_DIM if wide else sparse_layout.CSC_FROM_DIM - 1
    rows, cols = rng.integers(0, n, 4000), rng.integers(0, d, 4000)
    _, first = np.unique(rows * d + cols, return_index=True)
    rows, cols = rows[first], cols[first]
    vals = rng.normal(size=len(rows)).astype(np.float32)
    coo = (torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), n, d)
    L = sparse_layout.from_coo(*coo, csc=csc)
    full = sparse_layout.from_coo(*coo, csc=True)
    want = wide if csc is None else csc  # None: only where a two-pass route may read it
    assert L.has_csc == want
    assert all((getattr(L, f) is not None) == want for f in CSC_FIELDS)
    csc_bytes = sum(getattr(full, f).numel() * getattr(full, f).element_size() for f in CSC_FIELDS)
    assert csc_bytes == 8 * L.nnz + 8 * (d + 1) * 2 + 8 * (full.n_chunks + 1)
    assert L.nbytes() == full.nbytes() - (0 if want else csc_bytes)
    assert L.n_chunks == (full.n_chunks if want else 0)
    for f in dataclasses.fields(L):  # the CSR arrays and the tiles are the same either way
        if f.name not in CSC_FIELDS and f.name not in ("n_rows", "dim"):
            assert torch.equal(getattr(L, f.name), getattr(full, f.name)), f.name
    w, u = torch.randn(d), torch.randn(n)
    assert torch.equal(sparse_kernels.matvec(L, w), sparse_kernels.matvec_plain(full, w))
    for square in (False, True):
        assert torch.equal(sparse_kernels.rmatvec(L, u, square=square),
                           sparse_kernels.rmatvec_plain(full, u, square))
    args = (losses.LOGISTIC, 0.1 * w, 0.0, L, (u > 0).float(), u, torch.ones(n))
    for g, r in zip(sparse_kernels.fused_value_gradient_sums(*args),
                    sparse_kernels.fused_value_gradient_sums_plain(*args[:3], full, *args[4:])):
        assert torch.equal(g, r)


def test_a_route_that_reads_the_csc_copy_raises_without_it():
    L = sparse_layout.from_coo(torch.tensor([0, 1]), torch.tensor([2, 3]),
                               torch.tensor([1.0, 2.0]), 4, 5, csc=False)
    with pytest.raises(ValueError, match="sparse_rmatvec \\(two_pass\\).*csc=True"):
        sparse_kernels._require_csc(L, "sparse_rmatvec (two_pass)")
    sparse_kernels._require_csc(sparse_layout.from_coo(
        torch.tensor([0, 1]), torch.tensor([2, 3]), torch.tensor([1.0, 2.0]), 4, 5, csc=True), "any")


def test_layout_rejects_entries_outside_the_matrix():
    with pytest.raises(ValueError):
        sparse_layout.from_coo(torch.tensor([0, 3]), torch.tensor([1, 1]), torch.ones(2), 3, 2)
    with pytest.raises(ValueError):
        sparse_layout.from_coo(torch.tensor([0, 1]), torch.tensor([1, 2]), torch.ones(2), 3, 2)


# ------------------------------------------------------------ the ELL container


def _ell(seed=3, n=400, d=90, k=12):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)  # duplicates within rows included
    val = rng.normal(size=(n, k)).astype(np.float32)
    val[::9, 6:] = 0.0  # short rows: padding at index 0 or anywhere, value 0
    idx[::9, 6:] = 0
    return idx, val, rng


def test_ell_products_match_jax_sparse_features():
    idx, val, rng = _ell()
    d = 90
    jsf = jax_containers.SparseFeatures(jnp.asarray(idx), jnp.asarray(val), d)
    sf = SparseFeatures(torch.from_numpy(idx), torch.from_numpy(val), d)
    w = rng.normal(size=d).astype(np.float32)
    u = rng.normal(size=idx.shape[0]).astype(np.float32)
    tol = PORT_TOLERANCES["objective"]
    np.testing.assert_allclose(sf.matvec(torch.from_numpy(w)).numpy(),
                               np.asarray(jsf.matvec(jnp.asarray(w))), rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(sf.rmatvec(torch.from_numpy(u)).numpy(),
                               np.asarray(jsf.rmatvec(jnp.asarray(u))), rtol=tol["rtol"], atol=tol["atol"])
    np.testing.assert_allclose(sf.sq_rmatvec(torch.from_numpy(u)).numpy(),
                               np.asarray(jsf.sq_rmatvec(jnp.asarray(u))), rtol=tol["rtol"], atol=tol["atol"])
    assert sf.shape == jsf.shape


def test_ell_products_are_plain_cpu_only():
    sf = SparseFeatures(torch.zeros(2, 1, dtype=torch.int32, device="meta"),
                        torch.zeros(2, 1, device="meta"), 3)
    with pytest.raises(RuntimeError):
        sf.rmatvec(torch.zeros(2, device="meta"))


def test_pack_csr_to_ell_matches_jax_and_sums_duplicates():
    rng = np.random.default_rng(8)
    n, d = 300, 50
    lens = rng.integers(0, 9, size=n)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    indices = rng.integers(0, d, size=indptr[-1])
    values = rng.normal(size=indptr[-1]).astype(np.float32)
    assert len(np.unique(np.repeat(np.arange(n), lens) * d + indices)) < len(indices)  # duplicates
    got = pack_csr_to_ell(indptr, indices, values, d)
    ref = jax_containers.pack_csr_to_ell(indptr, indices, values, d, device=False)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    assert got.dim == d and got.indices.dtype == torch.int32
    clean = pack_csr_to_ell(np.array([0, 2, 2, 3]), np.array([4, 1, 0]), np.ones(3, np.float32), 5)
    assert clean.indices.tolist() == [[4, 1], [0, 0], [0, 0]]  # CSR order kept, rows padded
    assert clean.values.tolist() == [[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]]
