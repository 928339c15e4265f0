"""Sparse GLM products and fused objective sums: CUDA kernels and their plain versions.

Port of `photon_ml_tpu/ops/pallas_sparse.py`'s three kernels
(`_matvec_kernel`, `_rmatvec_kernel`, `_fused_kernel`) over the port's
layout (data/sparse_layout.py). The kernels are hand-written CUDA for
Hopper in `photon_ml_tpu_torch/csrc/sparse_glm.cu`; its header says what
bounds them on the card and how the design answers that.
`ops/cuda_build.py` builds it with `nvcc` at first use; it is bound here
with ctypes.

Contract (raw sums over all entries; normalization and L2 stay with the
caller in ops/objective.py):

    matvec(layout, w)              -> z = X w
    rmatvec(layout, u)             -> g = X^T u
    rmatvec(layout, u, square=True) -> (X o X)^T u
    fused_value_gradient_sums      -> (value, grad_raw, sum_u)
        z = X w_eff + offset + shift, value = sum wt l(z, y),
        u = wt l'(z, y), grad_raw = X^T u, sum_u = sum u

The layout has no levels, so there is no `z_extra` and no COO tail.
Each kernel runs one of two routes, chosen from `dim` alone (`matvec_route`,
`rmatvec_route`, `fused_route`): SINGLE_STREAM streams the row tiles once
through shared memory, with w and/or the gradient held there, up to
MATVEC_STREAM_MAX_DIM / RMATVEC_STREAM_MAX_DIM / FUSED_STREAM_MAX_DIM (the
widths live in data/sparse_layout.py, which builds the CSC copy only above
the narrowest); TWO_PASS reads the CSR rows forward and the CSC chunks
backward on any width. `matvec_two_pass`, `rmatvec_two_pass` and
`fused_value_gradient_sums_two_pass` take the two-pass route on any width,
so that the routes can be timed side by side; on a CUDA layout without
the CSC copy, a route that reads it raises instead of building it.

Dispatch is by where the tensors lie, and nowhere else: a CUDA layout
launches the kernel or raises; a CPU layout takes the plain PyTorch version
beside each kernel (gather and `index_add_` over the CSR entries), which the
CPU tests hold against the JAX package and which `chip_smoke.py` holds the
kernels against on the card. `LAUNCHES` counts wrapper calls that launched
their kernel, on either route.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from photon_ml_tpu_torch.data.sparse_layout import (
    FUSED_STREAM_MAX_DIM,
    MATVEC_STREAM_MAX_DIM,
    RMATVEC_STREAM_MAX_DIM,
    SparseLayout,
)
from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.glm_kernels import Scalar, as_scalar
from photon_ml_tpu_torch.ops.losses import LOSS_IDS, PointwiseLoss

Tensor = torch.Tensor

SOURCE = cuda_build.CSRC_DIR / "sparse_glm.cu"

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (the CPU path does not count).
LAUNCHES: Dict[str, int] = {"sparse_fused": 0, "sparse_matvec": 0, "sparse_rmatvec": 0}

SINGLE_STREAM = "single_stream"
TWO_PASS = "two_pass"
# `sparse_stream_max_dim`'s kernel numbers.
STREAM_KERNELS = {"matvec": 0, "fused": 1, "rmatvec": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sparse_max_forward_blocks.argtypes = []
    lib.sparse_max_forward_blocks.restype = i
    lib.sparse_stream_max_dim.argtypes = [i]
    lib.sparse_stream_max_dim.restype = i
    lib.sparse_matvec_tiles.argtypes = [ll, i, p, p, p, p, p, i, p, p, p, p]
    lib.sparse_matvec_tiles.restype = i
    lib.sparse_fused_tiles.argtypes = [i, i, p, p, p, p, p, p, i, p, p, p, p, p, p, p, p, p, p]
    lib.sparse_fused_tiles.restype = i
    lib.sparse_matvec_rows.argtypes = [ll, i, p, p, p, p, p, p]
    lib.sparse_matvec_rows.restype = i
    lib.sparse_rmatvec_tiles.argtypes = [i, i, p, p, p, p, p, p, i, p, p, p, p, p]
    lib.sparse_rmatvec_tiles.restype = i
    lib.sparse_rmatvec_chunks.argtypes = [i, i, ll, p, p, p, p, p, p, p, p]
    lib.sparse_rmatvec_chunks.restype = i
    lib.sparse_fused_two_pass.argtypes = [i, ll, i, p, p, p, p, p, p, p, p, p, p, ll, p, p, p, p, p,
                                          p, p]
    lib.sparse_fused_two_pass.restype = i
    lib.sparse_error_string.argtypes = [i]
    lib.sparse_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _bind)


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    cuda_build.check_rc(rc, what, lib.sparse_error_string)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _require_csc(layout: SparseLayout, what: str) -> None:
    """Raise where a route that reads the CSC copy meets a layout without it."""
    if not layout.has_csc:
        raise ValueError(
            f"{what} reads the CSC copy, which this layout was built without (dim {layout.dim}); "
            f"build it with sparse_layout.from_coo/from_ell(..., csc=True)")


# -------------------------------------------------------------- validation


def _check_vectors(layout: SparseLayout, cols: Dict[str, Tensor], rows: Dict[str, Tensor]) -> None:
    dev = layout.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in list(cols.items()) + list(rows.items()):
        want = layout.dim if name in cols else layout.n_rows
        if t.shape != (want,):
            raise ValueError(f"{name} must have shape ({want},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the layout on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# -------------------------------------------------------------- plain versions


def _entry_rows(layout: SparseLayout) -> Tensor:
    counts = layout.row_ptr[1:] - layout.row_ptr[:-1]
    return torch.arange(layout.n_rows, device=layout.device).repeat_interleave(counts)


def matvec_plain(layout: SparseLayout, w: Tensor) -> Tensor:
    """z = X w: gather w at the CSR columns, scatter-add into the rows."""
    z = torch.zeros(layout.n_rows, dtype=w.dtype, device=w.device)
    return z.index_add_(0, _entry_rows(layout), layout.row_val * w[layout.col_idx.long()])


def rmatvec_plain(layout: SparseLayout, u: Tensor, square: bool = False) -> Tensor:
    """g = X^T u (or (X o X)^T u): the CSR entries scatter-added into columns."""
    v = layout.row_val * layout.row_val if square else layout.row_val
    g = torch.zeros(layout.dim, dtype=u.dtype, device=u.device)
    return g.index_add_(0, layout.col_idx.long(), v * u[_entry_rows(layout)])


def fused_value_gradient_sums_plain(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, layout: SparseLayout,
    labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    z = matvec_plain(layout, w_eff) + (offsets + as_scalar(shift, w_eff))
    value = torch.sum(weights * loss.loss(z, labels))
    u = weights * loss.d1(z, labels)
    return value, rmatvec_plain(layout, u), torch.sum(u)


# ------------------------------------------------------------------ wrappers


def matvec_route(dim: int) -> str:
    """The route of `matvec` at this width."""
    return SINGLE_STREAM if dim <= MATVEC_STREAM_MAX_DIM else TWO_PASS


def rmatvec_route(dim: int) -> str:
    """The route of `rmatvec` at this width."""
    return SINGLE_STREAM if dim <= RMATVEC_STREAM_MAX_DIM else TWO_PASS


def fused_route(dim: int) -> str:
    """The route of `fused_value_gradient_sums` at this width."""
    return SINGLE_STREAM if dim <= FUSED_STREAM_MAX_DIM else TWO_PASS


def matvec(layout: SparseLayout, w: Tensor) -> Tensor:
    """z = X w: the CUDA kernel of `matvec_route(dim)` for a CUDA layout,
    the plain version on the CPU."""
    return _matvec(layout, w, matvec_route(layout.dim))


def matvec_two_pass(layout: SparseLayout, w: Tensor) -> Tensor:
    """z = X w on the two-pass route's CSR forward, on any width."""
    return _matvec(layout, w, TWO_PASS)


def _matvec(layout: SparseLayout, w: Tensor, route: str) -> Tensor:
    _check_vectors(layout, {"w": w}, {})
    if layout.device.type == "cpu":
        return matvec_plain(layout, w)
    lib = _library()
    z = torch.empty(layout.n_rows, dtype=torch.float32, device=layout.device)
    with torch.cuda.device(layout.device):
        if route == SINGLE_STREAM:
            rc = lib.sparse_matvec_tiles(
                layout.n_rows, layout.dim, layout.row_ptr.data_ptr(), layout.col_idx.data_ptr(),
                layout.row_val.data_ptr(), layout.tile_row.data_ptr(), layout.tile_ptr.data_ptr(),
                layout.n_slabs, layout.slab_tile.data_ptr(), w.data_ptr(), z.data_ptr(),
                _stream(layout.device),
            )
        else:
            rc = lib.sparse_matvec_rows(
                layout.n_rows, layout.dim, layout.row_ptr.data_ptr(), layout.col_idx.data_ptr(),
                layout.row_val.data_ptr(), w.data_ptr(), z.data_ptr(), _stream(layout.device),
            )
    _check_rc(lib, rc, f"sparse_matvec launch ({route})")
    LAUNCHES["sparse_matvec"] += 1
    return z


def rmatvec(layout: SparseLayout, u: Tensor, *, square: bool = False) -> Tensor:
    """g = X^T u, or (X o X)^T u with `square`: the CUDA kernel of
    `rmatvec_route(dim)` for a CUDA layout, the plain version on the CPU."""
    return _rmatvec(layout, u, square, rmatvec_route(layout.dim))


def rmatvec_two_pass(layout: SparseLayout, u: Tensor, square: bool = False) -> Tensor:
    """g = X^T u (or (X o X)^T u) on the two-pass route's CSC kernel, on any
    width; a CUDA layout must carry the CSC copy."""
    return _rmatvec(layout, u, square, TWO_PASS)


def _rmatvec(layout: SparseLayout, u: Tensor, square: bool, route: str) -> Tensor:
    _check_vectors(layout, {}, {"u": u})
    if layout.device.type == "cpu":
        return rmatvec_plain(layout, u, square)
    if route == TWO_PASS:
        _require_csc(layout, "sparse_rmatvec (two_pass)")
    lib = _library()
    dev = layout.device
    g = torch.empty(layout.dim, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if route == SINGLE_STREAM:
            # The row tiles only: no CSC array is passed, none is read.
            partial = torch.empty(layout.n_slabs * layout.dim, dtype=torch.float32, device=dev)
            rc = lib.sparse_rmatvec_tiles(
                int(square), layout.dim, layout.row_ptr.data_ptr(), layout.col_idx.data_ptr(),
                layout.row_val.data_ptr(), layout.tile_perm.data_ptr(), layout.tile_row.data_ptr(),
                layout.tile_ptr.data_ptr(), layout.n_slabs, layout.slab_tile.data_ptr(),
                u.data_ptr(), partial.data_ptr(), g.data_ptr(), _stream(dev),
            )
        else:
            chunk_sum = torch.empty(layout.n_chunks, dtype=torch.float32, device=dev)
            rc = lib.sparse_rmatvec_chunks(
                int(square), layout.dim, layout.n_chunks, layout.chunk_start.data_ptr(),
                layout.chunk_ptr.data_ptr(), layout.row_idx.data_ptr(), layout.col_val.data_ptr(),
                u.data_ptr(), chunk_sum.data_ptr(), g.data_ptr(), _stream(dev),
            )
    _check_rc(lib, rc, f"sparse_rmatvec launch ({route})")
    LAUNCHES["sparse_rmatvec"] += 1
    return g


def fused_value_gradient_sums(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, layout: SparseLayout,
    labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(value, grad_raw, sum_u): the CUDA kernels of `fused_route(dim)` for a
    CUDA layout, the plain version on the CPU."""
    return _fused(loss, w_eff, shift, layout, labels, offsets, weights, fused_route(layout.dim))


def fused_value_gradient_sums_two_pass(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, layout: SparseLayout,
    labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(value, grad_raw, sum_u) on the two-pass route, on any width."""
    return _fused(loss, w_eff, shift, layout, labels, offsets, weights, TWO_PASS)


def _fused(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, layout: SparseLayout,
    labels: Tensor, offsets: Tensor, weights: Tensor, route: str,
) -> Tuple[Tensor, Tensor, Tensor]:
    _check_vectors(layout, {"w_eff": w_eff},
                   {"labels": labels, "offsets": offsets, "weights": weights})
    if layout.device.type == "cpu":
        return fused_value_gradient_sums_plain(
            loss, w_eff, shift, layout, labels, offsets, weights)
    if route == TWO_PASS:
        _require_csc(layout, "sparse_fused (two_pass)")
    lib = _library()
    dev = layout.device
    shift_t = as_scalar(shift, w_eff)
    out = torch.empty(layout.dim + 2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if route == SINGLE_STREAM:
            # The row tiles only: no CSC array is passed, none is read.
            partial = torch.empty(layout.n_slabs * layout.dim, dtype=torch.float32, device=dev)
            stats = torch.empty(2 * layout.n_slabs, dtype=torch.float32, device=dev)
            rc = lib.sparse_fused_tiles(
                LOSS_IDS[loss.name], layout.dim, layout.row_ptr.data_ptr(),
                layout.col_idx.data_ptr(), layout.row_val.data_ptr(), layout.tile_perm.data_ptr(),
                layout.tile_row.data_ptr(), layout.tile_ptr.data_ptr(), layout.n_slabs,
                layout.slab_tile.data_ptr(), w_eff.data_ptr(), labels.data_ptr(),
                offsets.data_ptr(), weights.data_ptr(), shift_t.data_ptr(), partial.data_ptr(),
                stats.data_ptr(), out.data_ptr(), _stream(dev),
            )
        else:
            u = torch.empty(layout.n_rows, dtype=torch.float32, device=dev)
            partial = torch.empty(2 * lib.sparse_max_forward_blocks(), dtype=torch.float32,
                                  device=dev)
            chunk_sum = torch.empty(layout.n_chunks, dtype=torch.float32, device=dev)
            rc = lib.sparse_fused_two_pass(
                LOSS_IDS[loss.name], layout.n_rows, layout.dim, layout.row_ptr.data_ptr(),
                layout.col_idx.data_ptr(), layout.row_val.data_ptr(), w_eff.data_ptr(),
                labels.data_ptr(), offsets.data_ptr(), weights.data_ptr(), shift_t.data_ptr(),
                u.data_ptr(), partial.data_ptr(), layout.n_chunks, layout.chunk_start.data_ptr(),
                layout.chunk_ptr.data_ptr(), layout.row_idx.data_ptr(), layout.col_val.data_ptr(),
                chunk_sum.data_ptr(), out.data_ptr(), _stream(dev),
            )
    _check_rc(lib, rc, f"sparse_fused launch ({route})")
    LAUNCHES["sparse_fused"] += 1
    d = layout.dim
    return out[d], out[:d], out[d + 1]
