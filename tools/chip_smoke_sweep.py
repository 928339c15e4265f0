#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3w (batched hyperparameter sweeps) alone.

    PYTHONPATH=. python3 tools/chip_smoke_sweep.py

Builds the two kernel libraries the phase launches and the native Avro
library, all started together; writes phase 3e's training files and phase
3g's 1,000,000-row validation file with chip_smoke.py's generator; then
calls `chip_smoke.sweep_phase`, which fails on any check it fails (3w-bench,
3w-drills, 3w-e2e and 3w-sg). With 4 or more cards it then runs
`chip_smoke.sweep_groups_cli_phase` (3w-sg-cli: `cli.tune --sweep-mode
shard_group --shard-groups 2` against `--sweep-mode serial`, tuned-best
bit-equal). `--trace DIR` adds 3w-sg-trace: where one cold trial's time
goes, serial and in the group (chip_smoke.py `trace_group_trial`);
`--groups-only` runs 3w-sg-cli alone. About
4 minutes on one card, most of it nvcc and the phase itself. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, sparse_kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", metavar="DIR",
                    help="after 3w-sg's gates, time one cold trial's spans serial and in the "
                         "group and write a torch.profiler table of it to DIR")
    ap.add_argument("--groups-only", action="store_true",
                    help="skip 3w (its bench, drills, e2e and 3w-sg) and run 3w-sg-cli alone "
                         "(4 or more cards)")
    args = ap.parse_args(argv)
    cs.SG_TRACE_DIR = args.trace
    if not torch.cuda.is_available():
        print("chip_smoke_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE)]
    threads.append(threading.Thread(target=native_build.build_library, name="build-native"))
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
        launches = None
        if not args.groups_only:
            t0 = time.perf_counter()
            launches = cs.sweep_phase(root, val, work)
            print(f"wall: phase 3w {time.perf_counter() - t0:.1f} s", flush=True)
        if torch.cuda.device_count() >= 4:
            t0 = time.perf_counter()
            cs.sweep_groups_cli_phase(root, val, work)
            print(f"wall: phase 3w-sg-cli {time.perf_counter() - t0:.1f} s", flush=True)
        else:
            print("phase 3w-sg-cli: not run (needs 4 cards)", flush=True)
    print(launches, flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
