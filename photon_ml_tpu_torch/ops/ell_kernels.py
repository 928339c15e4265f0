"""The transposes of a random effect's batched ELL block: CUDA kernel and plain version.

A random-effect bucket over a sparse shard is an (E, S, K) ELL block, one
lane an entity (data/containers.py `SparseFeatures` with a batch axis). Its
solve needs, per lane, X^T u and (X o X)^T u over the lane's `dim`
features: the reference's `SparseFeatures.rmatvec` and `.sq_rmatvec`
(photon_ml_tpu/data/containers.py:73, :97), vmapped per lane. X w is a
gather and a sum over K (`SparseFeatures.matvec`), which needs no kernel.

    rmatvec(block, u)               -> (E, dim): X_e^T u_e per lane
    rmatvec(block, u, square=True)  -> (E, dim): (X_e o X_e)^T u_e

The kernel (`photon_ml_tpu_torch/csrc/ell_block.cu`, hand-written CUDA for
Hopper, built by `ops/cuda_build.py` at first use and bound here with
ctypes) adds each (lane, feature) cell's entries in (k, s) order, the
reference's, one thread a cell, from the block's transpose plan
(`containers.ell_transpose_plan`: the entries sorted by (lane, feature)
once per block). So every product has the same bits on every run and in
every process, without float atomics; the plain version, one
`scatter_add_` along the rows of each lane per ELL position k, adds in the
same order and has those bits too on the CPU.

Dispatch is by where the tensors lie, and nowhere else: a CUDA block
launches the kernel (and raises if it carries no plan); a CPU block takes
the plain version. `LAUNCHES` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Dict

import torch

from photon_ml_tpu_torch.ops import cuda_build

if TYPE_CHECKING:
    from photon_ml_tpu_torch.data.containers import SparseFeatures

Tensor = torch.Tensor

SOURCE = cuda_build.CSRC_DIR / "ell_block.cu"

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES: Dict[str, int] = {"ell_rmatvec": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ell_rmatvec_runs.argtypes = [i, i, ll, p, p, p, p, p, i, p, p]
    lib.ell_rmatvec_runs.restype = i
    lib.ell_block_error_string.argtypes = [i]
    lib.ell_block_error_string.restype = ctypes.c_char_p


def _library() -> ctypes.CDLL:
    return cuda_build.load_library(SOURCE, _bind)


def _check(block: "SparseFeatures", u: Tensor) -> None:
    lead = tuple(block.values.shape[:-1])
    if block.values.ndim != 3:
        raise ValueError(f"a batched ELL block is (E, S, K); got {tuple(block.values.shape)}")
    if tuple(u.shape) != lead:
        raise ValueError(f"u must have shape {lead}, got {tuple(u.shape)}")
    if u.device != block.values.device:
        raise ValueError(f"u is on {u.device}, the block on {block.values.device}")


def rmatvec_plain(block: "SparseFeatures", u: Tensor, square: bool = False) -> Tensor:
    """(E, dim) per-lane X^T u (or (X o X)^T u): each entry's term added
    into its lane's row by `scatter_add_`, one ELL position k at a time, so
    a cell's terms add in (k, s) order, the reference's (it scatters over
    (E, K, S) blocks). On the CPU a call adds along a row in order; on the
    card it adds with atomics."""
    E, _, K = block.values.shape
    v = block.values.to(u.dtype)
    terms = (v * v if square else v) * u[..., None]
    idx = block.indices.long()
    out = torch.zeros((E, block.dim), dtype=u.dtype, device=u.device)
    for k in range(K):
        out.scatter_add_(1, idx[..., k], terms[..., k])
    return out


def rmatvec(block: "SparseFeatures", u: Tensor, *, square: bool = False) -> Tensor:
    """(E, dim) per-lane X^T u, or (X o X)^T u with `square`: the CUDA
    kernel for a CUDA block (over its transpose plan), the plain version on
    the CPU. The plan leaves out rows of weight 0, so on the card u must be
    0 there, as every u of the objective is (it carries the weights)."""
    _check(block, u)
    if u.device.type == "cpu":
        return rmatvec_plain(block, u, square)
    plan = block.plan
    if plan is None:
        raise ValueError("a CUDA ELL block needs its transpose plan (containers.ell_transpose_plan; "
                         "game_dataset.gather_block_data builds it)")
    if u.dtype not in (torch.float32, torch.float64) or block.values.dtype != u.dtype:
        raise TypeError(f"values and u must be one of float32, float64; got {block.values.dtype}, "
                        f"{u.dtype}")
    E, S, K = block.values.shape
    if plan.shape != (E, S, K) or plan.dim != block.dim:
        raise ValueError(f"the plan is of a {plan.shape} block over {plan.dim} features; this block "
                         f"is {(E, S, K)} over {block.dim}")
    dev = u.device
    values, u = block.values.contiguous(), u.contiguous()
    out = torch.zeros(E * block.dim, dtype=u.dtype, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.ell_rmatvec_runs(
            int(u.dtype == torch.float64), int(square), plan.runs, plan.order.data_ptr(),
            plan.run_ptr.data_ptr(), plan.run_out.data_ptr(), values.data_ptr(), u.data_ptr(), K,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check_rc(rc, "ell_rmatvec launch", lib.ell_block_error_string)
    cuda_build.count_launch(LAUNCHES, "ell_rmatvec")
    return out.view(E, block.dim)
