#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3r (continuous refresh) alone.

    PYTHONPATH=. python3 tools/chip_smoke_refresh.py

Builds the kernel libraries 3r launches (`csrc/glm_fused.cu` for 3r-loop's
dense fixed effect, `csrc/sparse_glm.cu` for 3r-e2e's sparse one,
`csrc/ell_block.cu` for its random effects) and the native Avro library,
all started together; writes and reads phase 3e's training files (4,000,000
rows) onto the card; then calls `chip_smoke.refresh_phase` (3r-loop, then
3r-e2e), which fails on any gate it fails. Prints the card's name and power
limit last. Needs a CUDA card.
"""

from __future__ import annotations

import sys
import tempfile
import threading
import time

import torch

import chip_smoke as cs
from photon_ml_tpu_torch.native import build as native_build
from photon_ml_tpu_torch.ops import cuda_build, ell_kernels, glm_kernels, sparse_kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke_refresh: needs a CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    threads = [threading.Thread(target=cuda_build.build_library, args=(src,), name=f"build-{src.name}")
               for src in (glm_kernels.SOURCE, sparse_kernels.SOURCE, ell_kernels.SOURCE)]
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
        ds, maps = cs.read_e2e(root, dev, with_maps=True)
        torch.cuda.synchronize()
        print(f"3e's files written and read {time.perf_counter() - t0:.1f} s", flush=True)
        launches = cs.walled("phase 3r", cs.refresh_phase, ds, maps, a["truth"], a["n_users"],
                             a["n_movies"], dev)
    print(launches, flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
