#!/usr/bin/env python3
"""Where phase 3m's one-process and 4-worker fits part, lane by lane.

    PYTHONPATH=. python3 tools/mh_gap_probe.py [--rows N] [--device cuda|cpu]
        [--configs 1e-5:5,0.0:5] [--watch ROW]

Writes chip_smoke.py's 3m data (the e2e generator, 8 part files, a PHIDX
store) and, for each random-effect `tolerance:max.iter` pair of
`--configs`, trains 3m's coordinates (chip_smoke.MH_COORDINATES with that
pair) once in one process and once as `cli.train --multihost 4`, both on
`--device`. Then, as 3m holds them, each random effect of the multi-host
model against the one-process model on every entity's objective at the
one-process offsets, in float64: per coordinate the lanes over 1e-4 and
1e-3 and the six widest gaps, each beside the lane's optimum (L-BFGS from
the one-process lane, tolerance 0, 200 iterations) and its active rows.
For the first pair it also prints every random-effect solve of the
one-process fit: the lanes by convergence reason and by iterations, and
the `--watch` entity row's iterations, reason and loss. One JSON line a
reading. Runs on the card or, small, on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs


def train(args_of, work: str, label: str, device: str) -> dict:
    """The one-process and the 4-worker fit of 3m's command line."""
    from photon_ml_tpu_torch.cli import train as train_cli

    dirs = {n: os.path.join(work, f"{label}-{n}") for n in ("one", "full")}
    train_cli.main(args_of(dirs["one"], "--device", "cpu" if device == "cpu" else "cuda"))
    train_cli.main(args_of(dirs["full"], "--multihost", "4", "--device",
                           "cpu" if device == "cpu" else "cuda:0"))
    return {n: os.path.join(d, "models", "best") for n, d in dirs.items()}


def lane_gaps(ds, models: dict) -> dict:
    """Per coordinate: the multi-host model against the one-process one on
    each entity's objective at the one-process offsets, in float64."""
    from photon_ml_tpu_torch.data.game_dataset import RandomEffectDataConfig, build_random_effect_dataset
    from photon_ml_tpu_torch.ops import objective
    from photon_ml_tpu_torch.ops.losses import LOGISTIC
    from photon_ml_tpu_torch.optimize import problem
    from photon_ml_tpu_torch.optimize.config import L2, CoordinateOptimizationConfig, OptimizerConfig

    g = ds.shards["g"]
    dev = g.values.device
    reds = {cid: build_random_effect_dataset(ds, RandomEffectDataConfig(tag, "g", active_upper_bound=cap,
                                                                        min_bucket=8))
            for cid, (tag, cap) in cs.E2E_RE.items()}

    def matrix(coord, red):
        keys = sorted(red.entity_index, key=red.entity_index.get)
        art = {k: i for i, k in enumerate(coord.entity_ids)}
        src = np.fromiter((art.get(str(k), -1) for k in keys), np.int64, count=len(keys))
        out = np.zeros((len(keys) + 1, g.dim), np.float32)
        out[np.flatnonzero(src >= 0)] = np.asarray(coord.means, np.float32)[src[src >= 0]]
        return torch.from_numpy(out).to(dev)

    idx = g.indices.long()
    score = lambda w_rows: (g.values * w_rows).sum(dim=1)
    re = {n: {cid: matrix(m.coordinates[cid], red) for cid, red in reds.items()} for n, m in models.items()}
    fe = torch.as_tensor(np.asarray(models["one"].coordinates["global"].means, np.float32), device=dev)
    offsets = {"per-user": ds.offsets + score(fe[idx])}
    user_rows = reds["per-user"].sample_entity_rows.long()[:, None]
    offsets["per-movie"] = offsets["per-user"] + score(re["one"]["per-user"][user_rows, idx])
    polish = CoordinateOptimizationConfig(optimizer=OptimizerConfig(max_iterations=200, tolerance=0.0),
                                          regularization=L2, reg_weight=10.0)
    out = {}
    for cid, red in reds.items():
        gaps, worst = [], []
        for rows, blk in cs.re_lane_blocks(ds, red, offsets[cid]):
            f_one = objective.value(LOGISTIC, re["one"][cid][rows].double(), blk, None, 10.0)
            f_full = objective.value(LOGISTIC, re["full"][cid][rows].double(), blk, None, 10.0)
            gap = (f_one - f_full).abs() / f_full.abs().clamp_min(1.0)
            gaps.append(gap)
            sel = torch.topk(gap, min(6, gap.numel())).indices
            part = type(blk)(*(t[sel] for t in (blk.features, blk.labels, blk.offsets, blk.weights)))
            w0 = re["one"][cid][rows][sel].double()
            f_star = objective.value(LOGISTIC, problem.solve(LOGISTIC, part, polish, w0, None,
                                                             use_kernel=False).coefficients, part, None, 10.0)
            worst += [dict(entity_row=int(rows[e]), gap=float(gap[e]), f_one=float(f_one[e]),
                           f_multihost=float(f_full[e]), f_optimum=float(f_star[j]),
                           active_rows=int((blk.weights[e] != 0).sum())) for j, e in enumerate(sel.tolist())]
        gaps = torch.cat(gaps)
        out[cid] = dict(lanes=int(gaps.numel()), over_1e4=int((gaps > 1e-4).sum()),
                        over_1e3=int((gaps > 1e-3).sum()),
                        widest=sorted(worst, key=lambda w: -w["gap"])[:6])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=cs.E2E_ROWS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--configs", default="1e-5:5,0.0:5")
    ap.add_argument("--watch", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("mh_gap_probe: no CUDA device", file=sys.stderr)
        return 2
    from photon_ml_tpu_torch.cli import build_index
    from photon_ml_tpu_torch.data.index_map import IndexMap
    from photon_ml_tpu_torch.game import coordinate as coordinate_module
    from photon_ml_tpu_torch.io import model_store
    from photon_ml_tpu_torch.io.avro_data import FeatureShardConfig, read_game_dataset
    from photon_ml_tpu_torch.optimize import problem

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.E2E_ROWS = args.rows
    pairs = [p.split(":") for p in args.configs.split(",")]
    with tempfile.TemporaryDirectory(prefix="photon-mh-gap-") as work:
        data, index = os.path.join(work, "parts"), os.path.join(work, "index")
        os.makedirs(data)
        cs.write_e2e_files(data, cs.e2e_arrays(args.rows), cs.MH_PARTS)
        build_index.main(["--input-data-directories", data, "--feature-shard-configurations", cs.E2E_SHARD,
                          "--num-partitions", "1", "--output-dir", index])
        ds = imaps = None
        for k, (tol, iters) in enumerate(pairs):
            cs.MH_COORDINATES = [
                c.replace("tolerance=1e-5,max.iter=5", f"tolerance={tol},max.iter={iters}")
                + ",projector=IDENTITY" if "random.effect" in c else c for c in cs.E2E_COORDINATES]
            # The first pair's one-process fit records every random-effect solve.
            solves, gathers = [], []
            solve0, gather0 = problem.solve, coordinate_module.gather_block_data
            if k == 0:
                def solve(loss, block, cfg, w0, norm=None, use_kernel=None):
                    res = solve0(loss, block, cfg, w0, norm, use_kernel=use_kernel)
                    if w0.ndim == 2:
                        solves.append(res)
                    return res

                def gather(dataset, shard, blocks, *a, **kw):
                    gathers.append(blocks.entity_rows.cpu())
                    return gather0(dataset, shard, blocks, *a, **kw)

                problem.solve, coordinate_module.gather_block_data = solve, gather
            try:
                best = train(lambda out, *extra: cs.multihost_args(data, index, out, *extra), work,
                             f"tol{tol}-it{iters}", args.device)
            finally:
                problem.solve, coordinate_module.gather_block_data = solve0, gather0
            # The multi-host workers' solves are in their own processes; the
            # first len(gathers) solves recorded are the one-process fit's.
            for i, (res, rows) in enumerate(zip(solves, gathers)):
                line = dict(reading="solve", index=i, lanes=int(rows.numel()),
                            reasons=torch.bincount(res.reason.cpu().long(), minlength=5).tolist(),
                            iterations=torch.bincount(res.iterations.cpu().long(),
                                                      minlength=int(iters) + 1).tolist())
                hit = (rows == args.watch).nonzero()
                if len(hit):
                    j = int(hit[0, 0])
                    line.update(watch_iterations=int(res.iterations[j]), watch_reason=int(res.reason[j]),
                                watch_loss=float(res.loss[j]))
                print(json.dumps(line), flush=True)
            if imaps is None:
                imaps = {"g": IndexMap.load(os.path.join(best["one"], "feature-indexes", "g.json"))}
                ds = read_game_dataset(data, {"g": FeatureShardConfig(("features",), True)}, index_maps=imaps,
                                       id_tag_fields=cs.E2E_TAGS, device=args.device)[0]
            models = {n: model_store.load_game_model(d, imaps) for n, d in best.items()}
            print(json.dumps(dict(reading="gaps", tolerance=tol, max_iterations=int(iters),
                                  **lane_gaps(ds, models))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
