#!/usr/bin/env python3
"""Run chip_smoke.py's phases 2d-4d and 3e-d over NCCL alone, one rank a card.

    PYTHONPATH=. python3 tools/chip_smoke_nccl.py

These phases are the part of chip_smoke.py that needs several cards; the
script runs them (with every other phase) wherever the machine has two or
more. This runs them without the rest: phase 1's builds of the libraries
the ranks load, phase 2's data and the single-process sums the ranks are
held against, then `chip_smoke.across_cards` (up to 4 ranks); then 3e's
Avro files, 3e's one-process sweep on card 0 as the reference, and
`chip_smoke.e2e_across_cards`, the e2e cell with two random effects on up
to 4 ranks (per-movie on a row view, its offsets and scores exchanged
between the cards); then, where the machine has 4 cards, phase 3m over
NCCL: `cli.train --multihost 4 --device cuda` (one worker a card) and its
kill drill (`chip_smoke.multihost_phase`). It fails on any check any of
them fails. Needs 2 or more CUDA cards.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs
from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, sparse_kernels
from photon_ml_tpu_torch.parallel import mesh as pmesh


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke_nccl: needs two or more CUDA cards", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"torch {torch.__version__}, {torch.cuda.device_count()} cards:\n{smi.stdout.strip()}",
          flush=True)
    for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE):
        cuda_build.build_library(src)
    native_build.build_library()
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
    del data, single

    with tempfile.TemporaryDirectory(prefix="photon-e2e-") as root:
        cs.write_e2e_files(root, cs.e2e_arrays(cs.E2E_ROWS))
        ds = cs.read_e2e(root, dev)
        coords, _ = cs.e2e_coordinates(ds, *cs.e2e_configs())
        phase3e = cs.e2e_result(ds, coords, run_coordinate_descent(coords, 1))
        e2e_data = cs.e2e_host_arrays(cs.read_e2e(root, "cpu"))
    del coords
    failures = []
    cs.e2e_across_cards(e2e_data, ds, phase3e, failures)
    if failures:
        raise SystemExit("phase 3e-d over NCCL failed: " + "; ".join(failures))
    del ds, phase3e, e2e_data
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= cs.MH_RANKS:
        with tempfile.TemporaryDirectory(prefix="photon-mh-") as work:
            cs.walled("phase 3m over NCCL", cs.multihost_phase, work, "cuda")
    else:
        print(f"phase 3m over NCCL needs {cs.MH_RANKS} cards; this machine has "
              f"{torch.cuda.device_count()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
