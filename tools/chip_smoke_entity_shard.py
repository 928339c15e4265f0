#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3v-sh (the row-sharded serving store) alone.

    PYTHONPATH=. python3 tools/chip_smoke_entity_shard.py

Builds the kernel libraries 3c's training launches (`csrc/sparse_glm.cu`,
`csrc/glm_fused.cu`, `csrc/exact_sum.cu`, `csrc/ell_block.cu`) and the
native Avro library, all started together; writes phase 3e's training
files; trains 3c's model with 3c's `cli.train` command line; writes 3g's
validation file and 3v's requests (both from the validation draw); then
calls `chip_smoke.entity_shard_phase`, which fails on any gate it fails. On
a machine with two or more cards its mesh is one shard a card over the
first 4; on one card, 4 shards on card 0. Prints the phase's launches and
every card's name and power limit last. Needs a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, ell_kernels, glm_kernels, sparse_kernels
from photon_ml_tpu_torch.parallel import mesh as pmesh


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_entity_shard: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE, ell_kernels.SOURCE)]
    threads.append(threading.Thread(target=native_build.build_library, name="build-native"))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"build {time.perf_counter() - t0:.1f} s; torch {torch.__version__}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="photon-e2e-") as root:
        t0 = time.perf_counter()
        a = cs.e2e_arrays(cs.E2E_ROWS)
        cs.write_e2e_files(root, a)
        train_out = os.path.join(root, "drivers", "train")
        train_cli.main(["--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
                        "--root-output-directory", train_out, "--feature-shard-configurations", cs.E2E_SHARD,
                        "--coordinate-configurations", *cs.E2E_COORDINATES,
                        "--coordinate-descent-iterations", "1", "--output-mode", "BEST",
                        "--logging-level", "WARNING"])
        work = os.path.join(root, "slice")
        val = cs.e2e_arrays(cs.E2E_ROWS // 4, seed=24, n_users=a["n_users"], n_movies=a["n_movies"],
                            truth=a["truth"])
        os.makedirs(os.path.join(work, "validation"))
        cs.write_e2e_files(os.path.join(work, "validation"), val)
        cs.write_serve_requests(os.path.join(work, "serve-requests"), val)
        del a, val
        print(f"files, 3c's model, 3g's validation file and 3v's requests {time.perf_counter() - t0:.1f} s",
              flush=True)
        launches = cs.walled("phase 3v-sh", cs.entity_shard_phase, root, work, dev)
    print(launches, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
