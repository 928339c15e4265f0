"""GLM objective: weighted loss value, gradient and Hessian products.

Port of `photon_ml_tpu/ops/objective.py`:

    z  = X (w*factor) - shifts.(w*factor) + offset
    f  = sum_i weight_i l(z_i, y_i) + l2/2 ||w||^2
    g  = factor * (X^T u - (sum u) shifts) + l2 w,   u = weight l'(z)
    Hv = factor * (X^T r - (sum r) shifts) + l2 v,
         r = weight l''(z) (X (v*factor) - shifts.(v*factor))

Features are a dense tensor, an ELL `SparseFeatures` (its plain CPU
products) or a `SparseLayout` (ops/sparse_kernels.py: the CUDA kernels on
the card, their plain versions on the CPU). Dense functions are
rank-generic: `w` may carry leading batch axes (B, D) against features
(B, N, D), which is how a random-effect bucket runs all its entity problems
at once. The 2-D single-problem case can take the fused CUDA kernels
(ops/glm_kernels.py for dense X, ops/sparse_kernels.py for a sparse
layout), which return the raw sums; normalization and L2 are applied here,
outside the kernel, exactly as in the JAX package.

`use_kernel`: None = the fused kernel when the features are a sparse layout
or a 2-D float32/bf16 CUDA tensor, else the composed path; False = the
composed path (X w and X^T u one by one, which on a CUDA sparse layout are
its matvec and rmatvec kernels).

Data whose rows are one rank's share carries a `mesh` (LabeledData.mesh).
Then every sum over rows crosses the ranks: the raw sums of this rank's
rows, whatever produced them, go through one exact cross-rank sum
(`over_ranks`, parallel/mesh.py) before normalization and L2, which is
where the JAX package's sharded kernels psum them (pallas_glm.py:705-779).
The dense kernel path calls the sharded wrappers of ops/glm_kernels.py,
which are the single-device kernels when there is no mesh and make the
same call to `over_ranks` when there is. Margins stay local.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.data.containers import LabeledData, SparseFeatures, ell_block_to_dense
from photon_ml_tpu_torch.data.sparse_layout import SparseLayout
from photon_ml_tpu_torch.ops import glm_kernels, sparse_kernels
from photon_ml_tpu_torch.ops.losses import PointwiseLoss
from photon_ml_tpu_torch.ops.normalization import NormalizationContext
from photon_ml_tpu_torch.parallel.mesh import over_ranks

Tensor = torch.Tensor
L2 = Union[float, Tensor]


def _eff(w: Tensor, norm: Optional[NormalizationContext]) -> Tuple[Tensor, Tensor]:
    """(effective coefficients, margin shift per problem)."""
    if norm is None or norm.is_identity:
        return w, torch.zeros(w.shape[:-1], dtype=w.dtype, device=w.device)
    return norm.effective_coefficients(w), norm.margin_shift(w)


def margin_params(w: Tensor, norm: Optional[NormalizationContext]) -> Tuple[Tensor, Tensor]:
    """Public view of the (effective coefficients, margin shift) pair for
    scoring-side consumers (the transformer's row-stable dense margins)."""
    return _eff(w, norm)


def _kernel_eligible(features, w: Tensor) -> bool:
    return (
        isinstance(features, Tensor)
        and features.ndim == 2
        and w.ndim == 1
        and features.is_cuda
        and features.dtype in (torch.float32, torch.bfloat16)
    )


def _use_kernel(use_kernel: Optional[bool], features, w: Tensor) -> bool:
    return use_kernel is not False and _kernel_eligible(features, w)


def _matvec(features, w: Tensor) -> Tensor:
    """X w per problem: (N, D) @ (D,) or (B, N, D) x (B, D) -> (B, N)."""
    if isinstance(features, SparseLayout):
        return sparse_kernels.matvec(features, w)
    if isinstance(features, SparseFeatures):
        return features.matvec(w)
    X = features if features.dtype == w.dtype else features.to(w.dtype)
    if X.ndim == 2:
        return X @ w
    return torch.einsum("...nd,...d->...n", X, w)


def _rmatvec(features, u: Tensor) -> Tensor:
    """X^T u per problem."""
    if isinstance(features, SparseLayout):
        return sparse_kernels.rmatvec(features, u)
    if isinstance(features, SparseFeatures):
        return features.rmatvec(u)
    X = features if features.dtype == u.dtype else features.to(u.dtype)
    if X.ndim == 2:
        return u @ X
    return torch.einsum("...n,...nd->...d", u, X)


def _sq_rmatvec(features, u: Tensor) -> Tensor:
    """sum_i u_i x_i^2 per feature (Hessian diagonals)."""
    if isinstance(features, SparseLayout):
        return sparse_kernels.rmatvec(features, u, square=True)
    if isinstance(features, SparseFeatures):
        return features.sq_rmatvec(u)
    X = features if features.dtype == u.dtype else features.to(u.dtype)
    return torch.einsum("...n,...nd->...d", u, X * X)


def _l2_value(w: Tensor, l2: L2) -> Tensor:
    return 0.5 * l2 * torch.sum(w * w, dim=-1)


def compute_margins(
    w: Tensor, data: LabeledData, norm: Optional[NormalizationContext] = None
) -> Tensor:
    w_eff, shift = _eff(w, norm)
    return _matvec(data.features, w_eff) + shift[..., None] + data.offsets


def value(
    loss: PointwiseLoss,
    w: Tensor,
    data: LabeledData,
    norm: Optional[NormalizationContext] = None,
    l2: L2 = 0.0,
) -> Tensor:
    z = compute_margins(w, data, norm)
    (val,) = over_ranks(data.mesh, torch.sum(data.weights * loss.loss(z, data.labels), dim=-1))
    return val + _l2_value(w, l2)


def value_and_gradient(
    loss: PointwiseLoss,
    w: Tensor,
    data: LabeledData,
    norm: Optional[NormalizationContext] = None,
    l2: L2 = 0.0,
    use_kernel: Optional[bool] = None,
) -> Tuple[Tensor, Tensor]:
    """One pass: margins computed once, shared by value and gradient. On the
    dense kernel path X is read once for both."""
    w_eff, shift = _eff(w, norm)
    args = (data.features, data.labels, data.offsets, data.weights)
    if _use_kernel(use_kernel, data.features, w):
        val, g, sum_u = glm_kernels.sharded_value_gradient_sums(
            loss, w_eff, shift, *args, mesh=data.mesh)
    else:
        if isinstance(data.features, SparseLayout) and use_kernel is not False:
            val, g, sum_u = sparse_kernels.fused_value_gradient_sums(loss, w_eff, shift, *args)
        else:
            z = _matvec(data.features, w_eff) + shift[..., None] + data.offsets
            val = torch.sum(data.weights * loss.loss(z, data.labels), dim=-1)
            u = data.weights * loss.d1(z, data.labels)
            g = _rmatvec(data.features, u)
            sum_u = torch.sum(u, dim=-1)
        val, g, sum_u = over_ranks(data.mesh, val, g, sum_u)
    if norm is not None and not norm.is_identity:
        if norm.shifts is not None:
            g = g - sum_u[..., None] * norm.shifts
        if norm.factors is not None:
            g = g * norm.factors
    return val + _l2_value(w, l2), g + l2 * w


def hessian_vector(
    loss: PointwiseLoss,
    w: Tensor,
    v: Tensor,
    data: LabeledData,
    norm: Optional[NormalizationContext] = None,
    l2: L2 = 0.0,
    use_kernel: Optional[bool] = None,
) -> Tensor:
    """H(w) v for the GLM losses (X^T diag(weight l'') X in normalized space).
    On the dense kernel path one read of X computes both X w and X v; a
    sparse layout composes two matvecs and one rmatvec, as the JAX package
    does."""
    w_eff, shift = _eff(w, norm)
    v_eff, v_shift = _eff(v, norm)
    args = (data.features, data.labels, data.offsets, data.weights)
    if _use_kernel(use_kernel, data.features, w):
        hv, sum_r = glm_kernels.sharded_hessian_vector_sums(
            loss, w_eff, shift, v_eff, v_shift, *args, mesh=data.mesh)
    else:
        z = _matvec(data.features, w_eff) + shift[..., None] + data.offsets
        q = _matvec(data.features, v_eff) + v_shift[..., None]
        r = data.weights * loss.d2(z, data.labels) * q
        hv, sum_r = over_ranks(data.mesh, _rmatvec(data.features, r), torch.sum(r, dim=-1))
    if norm is not None and not norm.is_identity:
        if norm.shifts is not None:
            hv = hv - sum_r[..., None] * norm.shifts
        if norm.factors is not None:
            hv = hv * norm.factors
    return hv + l2 * v


def hessian_diagonal(
    loss: PointwiseLoss,
    w: Tensor,
    data: LabeledData,
    norm: Optional[NormalizationContext] = None,
    l2: L2 = 0.0,
) -> Tensor:
    """diag H = factor^2 sum_i c_i (x_ij - s_j)^2 + l2, c = weight l'',
    expanded as sum c x^2 - 2 s (sum c x) + s^2 (sum c)."""
    w_eff, shift = _eff(w, norm)
    z = _matvec(data.features, w_eff) + shift[..., None] + data.offsets
    c = data.weights * loss.d2(z, data.labels)
    diag = _sq_rmatvec(data.features, c)
    if norm is not None and norm.shifts is not None:
        s = norm.shifts
        diag, lin, sum_c = over_ranks(
            data.mesh, diag, _rmatvec(data.features, c), torch.sum(c, dim=-1))
        diag = diag - 2.0 * s * lin + s * s * sum_c[..., None]
    else:
        (diag,) = over_ranks(data.mesh, diag)
    if norm is not None and norm.factors is not None:
        diag = diag * norm.factors * norm.factors
    return diag + l2


# The most bytes of densified rows `hessian_matrix` holds at a time (a row
# chunk of a single problem, or a lane chunk's (lanes, S, D) block and its
# (lanes, D, D) products in `optimize/problem.compute_variances`).
HESSIAN_CHUNK_BYTES = 1 << 28


def _dense_rows(features, r0: int, r1: int, dtype: torch.dtype) -> Tensor:
    """Rows [r0, r1) of a single problem's features as a dense (r1 - r0, D)
    matrix: a slice of a dense X, an ELL slice made dense, or a sparse
    layout's CSR entries of those rows written into zeros (the layout holds
    no (row, col) pair twice, so every cell is written at most once)."""
    if isinstance(features, SparseLayout):
        e0, e1 = int(features.row_ptr[r0]), int(features.row_ptr[r1])
        lengths = features.row_ptr[r0 + 1:r1 + 1] - features.row_ptr[r0:r1]
        rows = torch.repeat_interleave(torch.arange(r1 - r0, device=lengths.device), lengths)
        dense = torch.zeros((r1 - r0, features.dim), dtype=dtype, device=features.device)
        dense[rows, features.col_idx[e0:e1].long()] = features.row_val[e0:e1].to(dtype)
        return dense
    if isinstance(features, SparseFeatures):
        block = SparseFeatures(features.indices[r0:r1], features.values[r0:r1], features.dim)
        return ell_block_to_dense(block).to(dtype)
    return features[r0:r1].to(dtype)


def hessian_matrix(
    loss: PointwiseLoss,
    w: Tensor,
    data: LabeledData,
    norm: Optional[NormalizationContext] = None,
    l2: L2 = 0.0,
) -> Tensor:
    """The full D x D Hessian (FULL variances), the JAX package's
    `hessian_matrix`: H = F ((X - s) o c)^T (X - s) F + l2 I, c = weight l''.

    A single problem (w (D,)) forms H over row chunks of at most
    HESSIAN_CHUNK_BYTES densified at a time, summed in chunk order (the JAX
    package densifies the whole shard); a sparse shard's margins go through
    `_matvec` (on a layout on the card, the X w kernel), a dense matrix's
    through each chunk as it is made (a bf16 X is never widened whole).
    Batched lanes (w (B, D) over dense (B, S, D) blocks) form their
    (B, D, D) products at once, so the caller bounds B."""
    w_eff, shift = _eff(w, norm)
    shifts = None if norm is None else norm.shifts

    def curvature(z: Tensor, rows=slice(None)) -> Tensor:  # c = weight l''(z)
        return data.weights[..., rows] * loss.d2(z + shift[..., None] + data.offsets[..., rows],
                                                 data.labels[..., rows])

    if w.ndim == 1:
        n, dim = data.features.shape[-2], w.shape[-1]
        dense = isinstance(data.features, Tensor)
        c = None if dense else curvature(_matvec(data.features, w_eff))
        step = max(1, HESSIAN_CHUNK_BYTES // (dim * w.element_size()))
        H = torch.zeros((dim, dim), dtype=w.dtype, device=w.device)
        for r0 in range(0, n, step):
            r1 = min(n, r0 + step)
            X = _dense_rows(data.features, r0, r1, w.dtype)
            c_rows = curvature(X @ w_eff, slice(r0, r1)) if dense else c[r0:r1]
            if shifts is not None:
                X = X - shifts
            H += (X * c_rows[:, None]).T @ X
        (H,) = over_ranks(data.mesh, H)
    else:
        X = data.features.to(w.dtype)
        c = curvature(torch.einsum("...nd,...d->...n", X, w_eff))
        if shifts is not None:
            X = X - shifts[..., None, :]
        H = torch.einsum("...nd,...n,...ne->...de", X, c, X)
    if norm is not None and norm.factors is not None:
        H = H * norm.factors[..., :, None] * norm.factors[..., None, :]
    return H + l2 * torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
