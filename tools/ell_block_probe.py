#!/usr/bin/env python3
"""A random effect's ELL-block solve on one CUDA card, and 3e's sweep beside another version's.

    PYTHONPATH=. python3 tools/ell_block_probe.py kernel
    PYTHONPATH=. python3 tools/ell_block_probe.py sweep [--package-root DIR]
    PYTHONPATH=. python3 tools/ell_block_probe.py ab --other-root DIR

`kernel` builds `photon_ml_tpu_torch/csrc/ell_block.cu` (printing ptxas'
register and spill lines), then runs chip_smoke.py's `ell_kernel_check` on
per-user's largest chunk of 3e's cell (bench.py's e2e generator, 8 ids a
row over 200 and the intercept, 4,000,000 rows, built in memory), beside
the dense route's einsum on that block made dense, then chip_smoke.py's
phase 3e-w (the same cell over 16,384 ids) and `re_lane_check` on 3e-w's
per-user coordinate.

`sweep` imports `photon_ml_tpu_torch` from DIR (default: this checkout),
builds 3e's cell in memory on the card and times, after a warm-up sweep,
one sweep of 3e's coordinates (IDENTITY) and one refit of 3f's estimator
(INDEX_MAP): seconds by coordinate, peak device memory, and the device's
idle share of one more 3e sweep under torch.profiler. It uses only what
both versions have, so DIR may hold an earlier version of the package.

`ab` runs `sweep` on DIR's package and on this checkout's, in turns: other,
this, this, other, each in its own process.

One JSON line a reading, then the card's name and power limit from
nvidia-smi. Exits non-zero when no card is present or a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def load_chip_smoke():
    """This checkout's chip_smoke.py, by path (DIR may hold another)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def e2e_dataset(cs, dev):
    """3e's cell in memory: the e2e generator at chip_smoke.E2E_ROWS rows,
    one shard "g" (8 ids, duplicates summed, and the intercept: dim 201)."""
    from photon_ml_tpu_torch.data.containers import pack_csr_to_ell
    from photon_ml_tpu_torch.data.game_dataset import GameDataset

    a = cs.e2e_arrays(cs.E2E_ROWS)
    sf = pack_csr_to_ell(a["indptr"], a["ids"], a["vals"], cs.E2E_D + 1, extra_col=(cs.E2E_D, 1.0))
    return GameDataset.build({"g": sf}, a["labels"], id_tags={"userId": a["users"], "movieId": a["movies"]},
                             device=dev)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def kernel_mode(cs) -> int:
    import torch

    from photon_ml_tpu_torch.data.game_dataset import build_random_effect_dataset, gather_block_data
    from photon_ml_tpu_torch.game.coordinate import RandomEffectCoordinate
    from photon_ml_tpu_torch.ops import cuda_build, ell_kernels
    from photon_ml_tpu_torch.types import TaskType

    dev = torch.device("cuda")
    bw, f32_rate = cs.card_rates(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    path, build_log = cuda_build.build_library(ell_kernels.SOURCE, verbose=True)
    ptx = sorted({l.strip() for l in build_log.splitlines() if "registers" in l or "spill" in l})
    print(json.dumps(dict(reading="build", library=path.name, build_s=time.perf_counter() - t0, ptxas=ptx)),
          flush=True)
    ds = e2e_dataset(cs, dev)
    red = build_random_effect_dataset(ds, cs.e2e_re_config("per-user"))
    big = max(red.buckets, key=lambda b: b.num_entities * b.capacity)
    _, failures = cs.ell_kernel_check(gather_block_data(ds, "g", big), dev, 34, bw, f32_rate, "3e", dense=True)
    del ds, red, big
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        cs.wide_e2e_phase(0, dev, bw, f32_rate)
    except SystemExit as e:
        failures.append(str(e))
    print(json.dumps(dict(reading="3e-w wall", s=time.perf_counter() - t0)), flush=True)
    wide = cs.wide_e2e_dataset(cs.E2E_ROWS, dev)
    _, re_cfg = cs.e2e_configs()
    red = build_random_effect_dataset(wide, cs.e2e_re_config("per-user"))
    coord = RandomEffectCoordinate(wide, red, re_cfg, TaskType.LOGISTIC_REGRESSION)
    t0 = time.perf_counter()
    lanes = cs.re_lane_check(coord, wide.offsets, re_cfg)
    print(json.dumps(dict(reading="re_lane_check 3e-w per-user (IDENTITY)", s=time.perf_counter() - t0,
                          **lanes)), flush=True)
    if any(lanes["in_place"].values()):
        failures.append(f"lanes solved in place differ from the whole bucket's: {lanes['in_place']}")
    print(smi_line())
    if failures:
        print("ell_block_probe failed: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


def sweep_mode(cs, root: str) -> int:
    import torch

    from photon_ml_tpu_torch.game.coordinate_descent import run_coordinate_descent
    from photon_ml_tpu_torch.types import TaskType

    dev = torch.device("cuda")
    ds = e2e_dataset(cs, dev)
    fe_cfg, re_cfg = cs.e2e_configs()
    coords, _ = cs.e2e_coordinates(ds, fe_cfg, re_cfg)
    run_coordinate_descent(coords, 1)  # warm-up: first-use costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = run_coordinate_descent(coords, 1)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    peak_3e = torch.cuda.max_memory_allocated() / 2**30
    profile = cs.profile_sweep(coords, sweep_s)
    del coords
    torch.cuda.empty_cache()
    cfgs = {"global": fe_cfg, **{c: re_cfg for c in cs.E2E_RE}}
    est = cs.e2e_estimator(TaskType.LOGISTIC_REGRESSION)
    est.fit(ds, None, [cfgs])  # prepare, and first-use costs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    refit = est.fit(ds, None, [cfgs])[0]
    torch.cuda.synchronize()
    print(json.dumps(dict(reading="sweep", package=root, rows=cs.E2E_ROWS, sweep_3e_s=sweep_s,
                          sweep_3e_by_coordinate=result.timing, peak_3e_gib=peak_3e,
                          device_idle_share_3e=profile["device_idle_share"], profile_3e=profile,
                          refit_3f_s=time.perf_counter() - t0, refit_3f_by_coordinate=refit.timing,
                          peak_3f_gib=torch.cuda.max_memory_allocated() / 2**30)), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("kernel", "sweep", "ab"))
    ap.add_argument("--package-root", default=str(REPO))
    ap.add_argument("--other-root")
    args = ap.parse_args(argv)
    if args.mode == "ab":
        if not args.other_root:
            ap.error("ab needs --other-root")
        rc = 0
        for root in (args.other_root, str(REPO), str(REPO), args.other_root):
            rc |= subprocess.run([sys.executable, __file__, "sweep", "--package-root", root]).returncode
        print(smi_line())
        return rc
    sys.path.insert(0, args.package_root)
    import torch

    if not torch.cuda.is_available():
        print("ell_block_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = load_chip_smoke()
    return kernel_mode(cs) if args.mode == "kernel" else sweep_mode(cs, args.package_root)


if __name__ == "__main__":
    sys.exit(main())
