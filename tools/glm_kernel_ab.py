#!/usr/bin/env python3
"""Time the dense GLM kernels of this checkout beside another version's.

    git show <rev>:photon_ml_tpu_torch/csrc/glm_fused.cu > <dir>/glm_fused.cu
    git show <rev>:photon_ml_tpu_torch/csrc/glm_losses.cuh > <dir>/glm_losses.cuh
    (and any other header that version's glm_fused.cu includes)
    PYTHONPATH=. python3 tools/glm_kernel_ab.py --other-csrc <dir> [--build-dir <dir>]

Needs one CUDA card and nvcc. Builds `<dir>/glm_fused.cu` with the flags of
`ops/cuda_build.py` into the build directory (default: a temporary one) and
binds its C interface with ctypes: the current one, or the interface before
the rows route (`glm_tile_rows()` and `glm_max_blocks(dtype, loss, hvp,
out)` without d). At 1,048,576 x 512, bf16 and f32 X, the logistic loss
(and the three others on bf16), then with the logistic loss at widths of
the wide route (d = 2,048 and 4,096 bf16, 2,048 and 8,192 f32) with
1 GiB of X each, it holds each version's value/gradient and
Hessian-vector sums against the plain version under
PORT_TOLERANCES["kernel_vs_plain"] and times each, as CUDA-event medians of
20 calls, in turns: other, this, this, other. One JSON line a case, then
the card's name and power limit from nvidia-smi. Exits non-zero if either
version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from photon_ml_tpu_torch.contracts import PORT_TOLERANCES
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels
from photon_ml_tpu_torch.ops.losses import LOGISTIC, LOSS_IDS, POISSON, SMOOTHED_HINGE, SQUARED

# (n, d, dtype, losses): the main path's shape, then widths of the wide route.
CASES = [(1 << 20, 512, torch.bfloat16, "all"), (1 << 20, 512, torch.float32, "logistic")] + [
    ((1 << 30) // (d * (2 if dt == torch.bfloat16 else 4)), d, dt, "logistic")
    for d, dt in ((2048, torch.bfloat16), (4096, torch.bfloat16), (2048, torch.float32),
                  (8192, torch.float32))]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def scale_rel(got, ref) -> float:
    worst = 0.0
    for g, r in zip(got, ref):
        g, r = g.double(), r.double()
        scale = max(float(r.abs().max()), 1.0) if r.ndim == 0 else float(r.abs().max())
        worst = max(worst, float((g - r).abs().max()) / max(scale, 1e-30))
    return worst


class Other:
    """The other version's library, called as glm_kernels calls its own."""

    def __init__(self, source: Path, build_dir: Path):
        lib_path = build_dir / "libglm_fused_other.so"
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {source}:\n{proc.stderr}")
        self.lib = lib = ctypes.CDLL(str(lib_path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        self.takes_d = hasattr(lib, "glm_route")
        lib.glm_tile_rows.argtypes = [i, i] if self.takes_d else []
        lib.glm_tile_rows.restype = i
        lib.glm_max_blocks.argtypes = [i, i, i, i, ctypes.POINTER(i)] if self.takes_d else [i, i, i, ctypes.POINTER(i)]
        lib.glm_max_blocks.restype = i
        lib.glm_value_grad.argtypes = [i, i, p, ll, i, p, p, p, p, p, p, i, p, p]
        lib.glm_value_grad.restype = i
        lib.glm_hvp.argtypes = [i, i, p, ll, i, p, p, p, p, p, p, p, p, i, p, p]
        lib.glm_hvp.restype = i

    def sums(self, hvp: bool, loss, w, shift, v, v_shift, X, y, off, wt):
        n, d = X.shape
        dt, lid = (1 if X.dtype == torch.bfloat16 else 0), LOSS_IDS[loss.name]
        most = ctypes.c_int(0)
        if self.takes_d:
            rc = self.lib.glm_max_blocks(dt, lid, int(hvp), d, ctypes.byref(most))
            rows = self.lib.glm_tile_rows(dt, d)
        else:
            rc = self.lib.glm_max_blocks(dt, lid, int(hvp), ctypes.byref(most))
            rows = self.lib.glm_tile_rows()
        if rc != 0:
            raise RuntimeError(f"glm_max_blocks: CUDA error {rc}")
        blocks = max(1, min(-(-n // rows), most.value))
        width = d + (1 if hvp else 2)
        partial = torch.empty((blocks, width), device=X.device)
        out = torch.empty((width,), device=X.device)
        stream = torch.cuda.current_stream().cuda_stream
        if hvp:
            rc = self.lib.glm_hvp(dt, lid, X.data_ptr(), n, d, y.data_ptr(), off.data_ptr(),
                                  wt.data_ptr(), w.data_ptr(), v.data_ptr(), shift.data_ptr(),
                                  v_shift.data_ptr(), partial.data_ptr(), blocks, out.data_ptr(), stream)
        else:
            rc = self.lib.glm_value_grad(dt, lid, X.data_ptr(), n, d, y.data_ptr(), off.data_ptr(),
                                         wt.data_ptr(), w.data_ptr(), shift.data_ptr(),
                                         partial.data_ptr(), blocks, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"launch: CUDA error {rc}")
        return (out[:d], out[d]) if hvp else (out[d], out[:d], out[d + 1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other-csrc", required=True, type=Path,
                    help="directory holding the other version's glm_fused.cu and its headers")
    ap.add_argument("--build-dir", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("glm_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="glm-ab-") as tmp:
        build_dir = args.build_dir or Path(tmp)
        build_dir.mkdir(parents=True, exist_ok=True)
        other = Other(args.other_csrc / "glm_fused.cu", build_dir)
        cuda_build.build_library(glm_kernels.SOURCE)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
        tol = PORT_TOLERANCES["kernel_vs_plain"]["scale_rel"]
        bad = []
        for n, d, dtype, which in CASES:
            X = rnd(n, d).to(dtype)
            y = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
            off, wt = 0.1 * rnd(n), 0.5 + torch.rand(n, generator=gen, device=dev)
            w, v = (0.05 if d <= 512 else 0.02) * rnd(d), rnd(d)
            shift, v_shift = torch.tensor(0.01, device=dev), torch.tensor(0.02, device=dev)
            for loss in ((LOGISTIC, SQUARED, POISSON, SMOOTHED_HINGE) if which == "all" else (LOGISTIC,)):
                for hvp in (False, True):
                    if hvp:
                        mine = lambda: glm_kernels.hessian_vector_sums(loss, w, shift, v, v_shift, X, y, off, wt)
                        plain = glm_kernels.hessian_vector_sums_plain(loss, w, shift, v, v_shift, X, y, off, wt)
                    else:
                        mine = lambda: glm_kernels.value_gradient_sums(loss, w, shift, X, y, off, wt)
                        plain = glm_kernels.value_gradient_sums_plain(loss, w, shift, X, y, off, wt)
                    theirs = lambda: other.sums(hvp, loss, w, shift, v, v_shift, X, y, off, wt)
                    errs = dict(this=scale_rel(mine(), plain), other=scale_rel(theirs(), plain))
                    t = [time_ms(theirs), time_ms(mine), time_ms(mine), time_ms(theirs)]
                    row = dict(kernel="hvp" if hvp else "value_grad", loss=loss.name,
                               x_dtype=str(X.dtype).replace("torch.", ""), n=n, d=d,
                               route=glm_kernels.route(X), scale_rel_err=errs,
                               this_ms=t[1:3], other_ms=[t[0], t[3]])
                    print(json.dumps(row), flush=True)
                    if max(errs.values()) > tol:
                        bad.append(row)
            del X, plain
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi gave nothing")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
