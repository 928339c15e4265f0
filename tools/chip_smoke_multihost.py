#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3m (`cli.train --multihost 4` and its kill drill) alone.

    PYTHONPATH=. python3 tools/chip_smoke_multihost.py [--device cuda:0|cuda]

Builds the kernel libraries the workers launch (`csrc/sparse_glm.cu`,
`csrc/exact_sum.cu`, `csrc/glm_fused.cu`) and the native Avro library, all
started together, then calls `chip_smoke.multihost_phase`: 3e's rows as 8
part files, a PHIDX store, one process's `cli.train` on the card, then the
4-worker run and the drill, every gate of the phase. `--device cuda:0`
(the default) puts the four workers on one card over gloo; `--device
cuda` gives each a card over NCCL where the machine has four. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, glm_kernels, sparse_kernels
from photon_ml_tpu_torch.parallel import mesh as pmesh


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke_multihost: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, pmesh.SOURCE)]
    threads.append(threading.Thread(target=native_build.build_library, name="build-native"))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="photon-mh-") as work:
        launches = cs.walled("phase 3m", cs.multihost_phase, work, args.device)
    print(launches, flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
