#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3p (the runtime planner and the autopilot) alone.

    PYTHONPATH=. python3 tools/chip_smoke_autopilot.py

Builds the kernel libraries 3c's training launches (`csrc/sparse_glm.cu`,
`csrc/glm_fused.cu`, `csrc/exact_sum.cu`, `csrc/ell_block.cu`) and the
native Avro library, all started together; writes phase 3e's training
files; trains 3c's model with 3c's `cli.train` command line (its launches
counted, as 3c counts them); writes 3v's requests and replays them with
3v's `cli.serve` command line (3v's scores and serve profile); writes 3n's
variant models and runs 3n's `cli.serve --tenant` x3 (3n's scores and
profile); then calls `chip_smoke.planner_autopilot_phase`, which fails on
any gate it fails. Prints the phase's launches and the card's name and
power limit last. Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.cli import serve as serve_cli
from photon_ml_tpu_torch.cli import train as train_cli
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, ell_kernels, glm_kernels, sparse_kernels
from photon_ml_tpu_torch.parallel import mesh as pmesh


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_autopilot: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE, ell_kernels.SOURCE)]
    threads.append(threading.Thread(target=native_build.build_library, name="build-native"))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="photon-e2e-") as root:
        t0 = time.perf_counter()
        a = cs.e2e_arrays(cs.E2E_ROWS)
        cs.write_e2e_files(root, a)
        train_out = os.path.join(root, "drivers", "train")
        _, train_launches, _, _ = cs.counted(torch, lambda: train_cli.main([
            "--training-task", "LOGISTIC_REGRESSION", "--input-data-directories", root,
            "--root-output-directory", train_out, "--feature-shard-configurations", cs.E2E_SHARD,
            "--coordinate-configurations", *cs.E2E_COORDINATES, "--coordinate-descent-iterations", "1",
            "--output-mode", "BEST", "--logging-level", "WARNING"]))
        best = os.path.join(train_out, "models", "best")
        work = os.path.join(root, "slice")
        replay_dir = os.path.join(work, "serve-requests")
        cs.write_serve_requests(replay_dir, cs.e2e_arrays(cs.E2E_ROWS // 4, seed=24, n_users=a["n_users"],
                                                          n_movies=a["n_movies"], truth=a["truth"]))
        serve_cli.main(cs.serve_args(best, replay_dir, os.path.join(work, "serve")))
        variants = cs.tenant_variant_dirs(best, work, seed=83)
        cli_dir = os.path.join(work, "tenancy-requests")
        os.makedirs(cli_dir)
        cs.copy_blocks(os.path.join(replay_dir, "part-0.avro"), os.path.join(cli_dir, "part-0.avro"),
                       cs.TEN_CLI_BLOCKS)
        serve_cli.main(["--requests", cli_dir, "--root-output-directory", os.path.join(work, "serve-tenants"),
                        "--feature-shard-configurations", cs.E2E_SHARD, "--logging-level", "WARNING",
                        "--tenant", f"base={best}", "--tenant", f"v0={variants[0]}", "--tenant",
                        f"v1={variants[1]}"])
        print(f"files, 3c's model, 3v's and 3n's replays {time.perf_counter() - t0:.1f} s", flush=True)
        launches = cs.walled("phase 3p", cs.planner_autopilot_phase, root, work, dev, train_launches)
    print(launches, flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
