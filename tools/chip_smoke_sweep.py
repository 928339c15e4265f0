#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3w (batched hyperparameter sweeps) alone.

    PYTHONPATH=. python3 tools/chip_smoke_sweep.py

Builds the two kernel libraries the phase launches and the native Avro
library, all started together; writes phase 3e's training files and phase
3g's 1,000,000-row validation file with chip_smoke.py's generator; then
calls `chip_smoke.sweep_phase`, which fails on any check it fails (3w-bench,
3w-drills and 3w-e2e). About 4 minutes on one card, most of it nvcc and
the phase itself. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, sparse_kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,))
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE)]
    threads.append(threading.Thread(target=native_build.build_library))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="photon-e2e-") as root, \
            tempfile.TemporaryDirectory(prefix="photon-sweep-") as work:
        t0 = time.perf_counter()
        a = cs.e2e_arrays(cs.E2E_ROWS)
        cs.write_e2e_files(root, a)
        val = os.path.join(work, "validation")
        os.makedirs(val)
        cs.write_e2e_files(val, cs.e2e_arrays(cs.E2E_ROWS // 4, seed=24, n_users=a["n_users"],
                                              n_movies=a["n_movies"], truth=a["truth"]))
        print(f"files {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        launches = cs.sweep_phase(root, val, work)
        print(f"wall: phase 3w {time.perf_counter() - t0:.1f} s", flush=True)
    print(launches, flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
