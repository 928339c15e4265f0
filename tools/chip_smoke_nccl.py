#!/usr/bin/env python3
"""Run chip_smoke.py's phases 2d-4d over NCCL alone, one rank a card.

    PYTHONPATH=. python3 tools/chip_smoke_nccl.py

These phases are the part of chip_smoke.py that needs several cards; the
script runs them (with every other phase) wherever the machine has two or
more. This runs them without the rest: phase 1's builds of the two
libraries the ranks load, phase 2's data and the single-process sums the
ranks are held against, then `chip_smoke.across_cards` (up to 4 ranks),
which fails on any check it fails. Needs 2 or more CUDA cards.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels
from photon_ml_tpu_torch.parallel import mesh as pmesh


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke_nccl: needs two or more CUDA cards", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"torch {torch.__version__}, {torch.cuda.device_count()} cards:\n{smi.stdout.strip()}",
          flush=True)
    for src in (glm_kernels.SOURCE, pmesh.SOURCE):
        cuda_build.build_library(src)
    seed = 0
    Xf, Xe, entity, y = cs.glmix_arrays(seed, cs.N_ROWS, cs.D_FIXED, cs.D_RE, cs.N_ENTITIES)
    rng = np.random.default_rng(seed + 1)  # phase 2's draws, as chip_smoke.main makes them
    off = (rng.standard_normal(cs.N_ROWS, dtype=np.float32) * 0.1).astype(np.float32)
    wt = rng.uniform(0.5, 2.0, size=cs.N_ROWS).astype(np.float32)
    w = (rng.standard_normal(cs.D_FIXED, dtype=np.float32) * 0.05).astype(np.float32)
    v = rng.standard_normal(cs.D_FIXED, dtype=np.float32)
    arrays = dict(X=Xf, Xe=Xe, entity=entity, y=y, off=off, wt=wt, w=w, v=v)
    data = {k: (a if k == "entity" else cs.shared_tensor(torch, a)) for k, a in arrays.items()}
    dev = torch.device("cuda:0")
    _, single = cs.single_process_sums(arrays, dev)
    cs.across_cards(seed, data, single, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
