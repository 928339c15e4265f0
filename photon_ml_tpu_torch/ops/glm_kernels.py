"""Fused dense GLM objective sums: CUDA kernels and their plain versions.

Port of `photon_ml_tpu/ops/pallas_glm.py`'s two kernels (`_value_grad_kernel`
and `_hvp_kernel`). The kernels are hand-written CUDA for Hopper in
`photon_ml_tpu_torch/csrc/glm_fused.cu`; its header says what bounds them on
the card and how the design answers that, and which route (`route`) a
width takes. `ops/cuda_build.py` builds it with
`nvcc` into a shared library with a plain C interface at first use; it is
bound here with ctypes.

Contract (the TPU kernels' raw sums; normalization and L2 stay with the
caller in ops/objective.py):

    value_gradient_sums -> (value, grad_raw, sum_u)
        z = X w_eff + offset + shift, value = sum wt l(z, y),
        u = wt l'(z, y), grad_raw = X^T u, sum_u = sum u
    hessian_vector_sums -> (hv_raw, sum_r)
        q = X v_eff + v_shift, r = wt l''(z, y) q, hv_raw = X^T r

Dispatch is by where the tensors lie, and nowhere else: a CUDA tensor
launches the kernel or raises; a CPU tensor takes the plain PyTorch version
beside each kernel (`value_gradient_sums_plain`, `hessian_vector_sums_plain`),
which the CPU tests hold against the JAX package and which `chip_smoke.py`
holds the kernels against on the card. There is no fallback from a failed
build or launch. `LAUNCHES` counts kernel launches per wrapper.

The sharded wrappers port `pallas_glm.py:705 sharded_value_gradient_sums`
and `:746 sharded_hessian_vector_sums`, the TPU form of the reference's
treeAggregate: there, the per-device kernel under `shard_map` and a `psum`
of the raw sums; here, the same kernel on this rank's rows and one exact
cross-rank sum (`over_ranks`, parallel/mesh.py: one all_gather of each
rank's sums and the rank-order kernel of csrc/exact_sum.cu) in its place.
They return the single-device contract's raw sums over all ranks' rows, in
float32; with one rank, the same bits as the single-device kernel (the
float32 -> float64 -> float32 round trip is exact).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from photon_ml_tpu_torch.ops import cuda_build
from photon_ml_tpu_torch.ops.losses import LOSS_IDS, PointwiseLoss
from photon_ml_tpu_torch.parallel.mesh import RankMesh, over_ranks

Tensor = torch.Tensor
Scalar = Union[Tensor, float]

SOURCE = cuda_build.CSRC_DIR / "glm_fused.cu"

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else (the CPU path does not count). A sharded wrapper counts one
# launch of the kernel and its cross-rank sum.
LAUNCHES: Dict[str, int] = {"value_grad": 0, "hvp": 0, "sharded_value_grad": 0, "sharded_hvp": 0}

_DTYPE_IDS = {torch.float32: 0, torch.bfloat16: 1}

_max_blocks: Dict[Tuple[int, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------------ build


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.glm_route.argtypes = [i, i]
    lib.glm_route.restype = i
    lib.glm_tile_rows.argtypes = [i, i]
    lib.glm_tile_rows.restype = i
    lib.glm_max_blocks.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.glm_max_blocks.restype = i
    lib.glm_value_grad.argtypes = [i, i, p, ll, i, p, p, p, p, p, p, i, p, p]
    lib.glm_value_grad.restype = i
    lib.glm_hvp.argtypes = [i, i, p, ll, i, p, p, p, p, p, p, p, p, i, p, p]
    lib.glm_hvp.restype = i
    lib.glm_error_string.argtypes = [i]
    lib.glm_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _bind)


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    cuda_build.check_rc(rc, what, lib.glm_error_string)


def _grid_blocks(lib: ctypes.CDLL, dtype_id: int, loss_id: int, hvp: int, n: int, d: int,
                 device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (dtype_id, loss_id, hvp, d, index)
    if key not in _max_blocks:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = lib.glm_max_blocks(dtype_id, loss_id, hvp, d, ctypes.byref(out))
        _check_rc(lib, rc, "glm_max_blocks")
        if out.value < 1:
            raise RuntimeError("glm_fused kernel does not fit on this device")
        _max_blocks[key] = out.value
    tiles = -(-n // lib.glm_tile_rows(dtype_id, d))
    return max(1, min(tiles, _max_blocks[key]))


_ROUTES = {0: "chunked", 1: "rows", 2: "wide"}


def route(features: Tensor) -> str:
    """The kernels' route for this X (a CUDA tensor), from its width and
    dtype: "rows" (up to 1,024 columns: a warp a row, each element read
    from shared memory once), "wide" (up to 16,384: whole rows resident in
    shared memory, read twice there) or "chunked" (wider: 512-column chunks,
    all but a row's last read twice from device memory)."""
    return _ROUTES[_library().glm_route(_DTYPE_IDS[features.dtype], features.shape[1])]


# -------------------------------------------------------------- validation


def as_scalar(x: Scalar, like: Tensor) -> Tensor:
    """A 0-d float32 tensor on `like`'s device (device scalars stay there,
    so the kernels read them without a host sync)."""
    if isinstance(x, Tensor):
        if x.numel() != 1:
            raise ValueError(f"expected a scalar, got shape {tuple(x.shape)}")
        return x.reshape(()).to(device=like.device, dtype=torch.float32)
    return torch.tensor(float(x), dtype=torch.float32, device=like.device)


def _check_inputs(features: Tensor, vectors: Dict[str, Tensor], rows: Dict[str, Tensor]) -> None:
    if features.ndim != 2:
        raise ValueError(f"features must be 2-D (n, d), got shape {tuple(features.shape)}")
    if features.dtype not in _DTYPE_IDS:
        raise TypeError(f"features must be float32 or bfloat16, got {features.dtype}")
    if not features.is_contiguous():
        raise ValueError("features must be contiguous (row-major)")
    n, d = features.shape
    dev = features.device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    for name, t in list(vectors.items()) + list(rows.items()):
        want = d if name in vectors else n
        if t.shape != (want,):
            raise ValueError(f"{name} must have shape ({want},), got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, features on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# -------------------------------------------------------------- plain versions


def value_gradient_sums_plain(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, features: Tensor,
    labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The value/gradient raw sums with ordinary tensor ops (X read twice);
    bf16 X is widened to f32 first, so both read the same values."""
    X = features.float()
    z = X @ w_eff + (offsets + as_scalar(shift, X))
    value = torch.sum(weights * loss.loss(z, labels))
    u = weights * loss.d1(z, labels)
    return value, u @ X, torch.sum(u)


def hessian_vector_sums_plain(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, v_eff: Tensor, v_shift: Scalar,
    features: Tensor, labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor]:
    X = features.float()
    z = X @ w_eff + (offsets + as_scalar(shift, X))
    q = X @ v_eff + as_scalar(v_shift, X)
    r = weights * loss.d2(z, labels) * q
    return r @ X, torch.sum(r)


# ------------------------------------------------------------------ wrappers


def value_gradient_sums(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, features: Tensor,
    labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(value, grad_raw, sum_u): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    _check_inputs(features, {"w_eff": w_eff},
                  {"labels": labels, "offsets": offsets, "weights": weights})
    if features.device.type == "cpu":
        return value_gradient_sums_plain(loss, w_eff, shift, features, labels, offsets, weights)
    lib = _library()
    n, d = features.shape
    dtype_id, loss_id = _DTYPE_IDS[features.dtype], LOSS_IDS[loss.name]
    shift_t = as_scalar(shift, features)
    blocks = _grid_blocks(lib, dtype_id, loss_id, 0, n, d, features.device)
    partial = torch.empty((blocks, d + 2), dtype=torch.float32, device=features.device)
    out = torch.empty((d + 2,), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        rc = lib.glm_value_grad(
            dtype_id, loss_id, features.data_ptr(), n, d, labels.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), w_eff.data_ptr(), shift_t.data_ptr(),
            partial.data_ptr(), blocks, out.data_ptr(),
            torch.cuda.current_stream(features.device).cuda_stream,
        )
    _check_rc(lib, rc, "glm_value_grad launch")
    LAUNCHES["value_grad"] += 1
    return out[d], out[:d], out[d + 1]


def hessian_vector_sums(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, v_eff: Tensor, v_shift: Scalar,
    features: Tensor, labels: Tensor, offsets: Tensor, weights: Tensor,
) -> Tuple[Tensor, Tensor]:
    """(hv_raw, sum_r): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_inputs(features, {"w_eff": w_eff, "v_eff": v_eff},
                  {"labels": labels, "offsets": offsets, "weights": weights})
    if features.device.type == "cpu":
        return hessian_vector_sums_plain(
            loss, w_eff, shift, v_eff, v_shift, features, labels, offsets, weights
        )
    lib = _library()
    n, d = features.shape
    dtype_id, loss_id = _DTYPE_IDS[features.dtype], LOSS_IDS[loss.name]
    shift_t = as_scalar(shift, features)
    v_shift_t = as_scalar(v_shift, features)
    blocks = _grid_blocks(lib, dtype_id, loss_id, 1, n, d, features.device)
    partial = torch.empty((blocks, d + 1), dtype=torch.float32, device=features.device)
    out = torch.empty((d + 1,), dtype=torch.float32, device=features.device)
    with torch.cuda.device(features.device):
        rc = lib.glm_hvp(
            dtype_id, loss_id, features.data_ptr(), n, d, labels.data_ptr(),
            offsets.data_ptr(), weights.data_ptr(), w_eff.data_ptr(), v_eff.data_ptr(),
            shift_t.data_ptr(), v_shift_t.data_ptr(), partial.data_ptr(), blocks,
            out.data_ptr(), torch.cuda.current_stream(features.device).cuda_stream,
        )
    _check_rc(lib, rc, "glm_hvp launch")
    LAUNCHES["hvp"] += 1
    return out[:d], out[d]


# ------------------------------------------------------------- across ranks


def sharded_value_gradient_sums(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, features: Tensor,
    labels: Tensor, offsets: Tensor, weights: Tensor, *, mesh: Optional[RankMesh],
) -> Tuple[Tensor, Tensor, Tensor]:
    """(value, grad_raw, sum_u) over every rank's rows: this rank's sums
    (the CUDA kernel on CUDA tensors, the plain version on CPU ones), then
    one exact cross-rank sum (`parallel.mesh.over_ranks`). Without a mesh,
    `value_gradient_sums` itself."""
    sums = value_gradient_sums(loss, w_eff, shift, features, labels, offsets, weights)
    if mesh is None:
        return sums
    if features.is_cuda:
        LAUNCHES["sharded_value_grad"] += 1
    return over_ranks(mesh, *sums)


def sharded_hessian_vector_sums(
    loss: PointwiseLoss, w_eff: Tensor, shift: Scalar, v_eff: Tensor, v_shift: Scalar,
    features: Tensor, labels: Tensor, offsets: Tensor, weights: Tensor, *,
    mesh: Optional[RankMesh],
) -> Tuple[Tensor, Tensor]:
    """(hv_raw, sum_r) over every rank's rows, as `sharded_value_gradient_sums`."""
    sums = hessian_vector_sums(loss, w_eff, shift, v_eff, v_shift, features, labels, offsets, weights)
    if mesh is None:
        return sums
    if features.is_cuda:
        LAUNCHES["sharded_hvp"] += 1
    return over_ranks(mesh, *sums)
