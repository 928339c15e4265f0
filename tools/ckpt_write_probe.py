#!/usr/bin/env python3
"""Where a staged checkpoint write's time goes, on one CUDA card.

    PYTHONPATH=. python3 tools/ckpt_write_probe.py [--rows 27587] [--cols 181] [--reps 5]

A random-effect model of `rows` x `cols` float32 on the card (the e2e
cell's per-user shape by default) is written as one checkpoint step's file
in turns, synchronously and staged (`begin_model_write`, then `save`'s
join), with and without a stand-in validation on the card in between
(1,000,000 x 8 gathers and a sum, as a validation of 3g's file scores).
Also timed apart: a thread's start and join alone, the device-to-host copy
on the main thread and on a new thread, and the npz write with its fsync.
Prints one JSON line of medians in seconds, with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time


def main(argv=None) -> int:
    import torch

    from photon_ml_tpu_torch.game import checkpoint
    from photon_ml_tpu_torch.game.model import RandomEffectModel
    from photon_ml_tpu_torch.types import TaskType

    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=27587)
    p.add_argument("--cols", type=int, default=181)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    model = RandomEffectModel(torch.randn(args.rows, args.cols, device=dev, generator=g), None,
                              TaskType.LOGISTIC_REGRESSION)
    x = torch.randn(1_000_000, 8, device=dev, generator=g)
    idx = torch.randint(0, args.rows, (1_000_000,), device=dev, generator=g)

    def validation():
        s = (x * model.coefficients_matrix[idx, :8]).sum()
        return float(s)  # the host reads the metric, as the suite does

    def one_thread(fn):
        t = threading.Thread(target=fn, name="probe-thread")
        t0 = time.perf_counter()
        t.start()
        t.join()
        return time.perf_counter() - t0

    times = {k: [] for k in ("sync_write", "staged_join_only", "sync_write_then_validation",
                             "staged_write_behind_validation", "validation", "thread_start_join",
                             "fetch_main", "fetch_new_thread", "npz_fsync")}
    validation()
    with tempfile.TemporaryDirectory(prefix="ckpt-probe-", dir=os.getcwd()) as root:
        ck = checkpoint.CoordinateDescentCheckpoint(root)
        step = 0
        for _ in range(args.reps):
            for order in (("sync", "staged"), ("staged", "sync")):
                for mode in order:
                    for with_val in (False, True):
                        step += 1
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if mode == "sync":
                            if with_val:
                                validation()
                            ck._write_model_files(f"steps/{step}/m.npz", model)
                        else:
                            h = ck.begin_model_write(completed_steps=step, cid="m", model=model)
                            if with_val:
                                validation()
                            h[4].join()
                            h[3].result()
                        key = {("sync", False): "sync_write", ("staged", False): "staged_join_only",
                               ("sync", True): "sync_write_then_validation",
                               ("staged", True): "staged_write_behind_validation"}[mode, with_val]
                        times[key].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            validation()
            times["validation"].append(time.perf_counter() - t0)
            times["thread_start_join"].append(one_thread(lambda: None))
            t0 = time.perf_counter()
            host = model.coefficients_matrix.cpu()
            times["fetch_main"].append(time.perf_counter() - t0)
            times["fetch_new_thread"].append(one_thread(lambda: model.coefficients_matrix.cpu()))
            t0 = time.perf_counter()
            checkpoint._write_model_bytes(os.path.join(root, f"raw-{step}.npz"),
                                          checkpoint._npz_bytes({"matrix": host.numpy()}))
            times["npz_fsync"].append(time.perf_counter() - t0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(json.dumps(dict(probe="ckpt_write", rows=args.rows, cols=args.cols, reps=args.reps,
                          mib=args.rows * args.cols * 4 / 2**20,
                          median_s={k: statistics.median(v) for k, v in times.items()},
                          card=smi.stdout.strip().splitlines()[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
