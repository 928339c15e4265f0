#!/usr/bin/env python3
"""Is a row's dot product on the card independent of how many rows ride along?

    python3 tools/serving_row_sum_probe.py

The serving engine scores a request in a bucket of 1 to 256 rows, and the
transformer scores the same row inside a dataset of many rows; the
reference holds both bit-equal. This probe measures, on one CUDA card, how
many rows of `torch.sum(X * w, dim=-1)` (and of the same over gathered
coefficient rows, `matrix[rows]`) differ in any bit between a bucket of b
rows and one pass over 65,536 rows, for widths 16, 201 and 512 and every
power-of-two bucket up to 256, and the same for `game.model.row_sum` (the
port's pairwise row reduction). It also captures one small program (gather,
row reduction, sigmoid) in a CUDA graph on a side stream from a worker
thread while the main thread runs eager work, replays it on new inputs and
holds the result bit-equal to the eager program. Prints one JSON line per
reading and exits non-zero when no card is present.
"""

from __future__ import annotations

import json
import sys
import threading


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serving_row_sum_probe: no CUDA device", file=sys.stderr)
        return 2
    from photon_ml_tpu_torch.game.model import row_sum

    dev = torch.device("cuda")
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), torch=torch.__version__,
                          cuda=torch.version.cuda)))
    gen = torch.Generator(device=dev).manual_seed(0)
    n_all, n_probe = 65536, 4096
    for d in (16, 201, 512):
        X = torch.randn(n_all, d, generator=gen, device=dev)
        w = torch.randn(d, generator=gen, device=dev) * 0.05
        M = torch.randn(8193, d, generator=gen, device=dev) * 0.05
        rows = torch.randint(0, 8193, (n_all,), generator=gen, device=dev)
        for name, fn in (("torch.sum", lambda P: torch.sum(P, dim=-1)), ("row_sum", row_sum)):
            full_fe = fn(X * w)
            full_re = fn(X * M[rows])
            for b in (1, 2, 4, 8, 16, 32, 64, 128, 256):
                diff_fe = diff_re = 0
                for lo in range(0, n_probe, b):
                    sl = slice(lo, lo + b)
                    diff_fe += int((fn(X[sl] * w) != full_fe[sl]).sum())
                    diff_re += int((fn(X[sl] * M[rows[sl]]) != full_re[sl]).sum())
                print(json.dumps(dict(reduction=name, d=d, bucket=b, rows=n_probe,
                                      fe_rows_differing=diff_fe, re_rows_differing=diff_re)))

    # A CUDA graph captured from a worker thread while the main thread runs.
    d, b = 201, 256
    M = torch.randn(5406, d, generator=gen, device=dev)
    w = torch.randn(d, generator=gen, device=dev)
    feats = torch.zeros(b, d, device=dev)
    idx = torch.zeros(b, dtype=torch.long, device=dev)

    def program():
        total = row_sum(feats * w) + row_sum(feats * M[idx])
        return torch.stack((total, torch.sigmoid(total)))

    out = {}

    def capture():
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            program()
        side.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side, capture_error_mode="thread_local"):
            out["static"] = program()
        out["graph"] = g

    busy = torch.randn(4096, 4096, device=dev)
    t = threading.Thread(target=capture, name="probe-capture")
    t.start()
    for _ in range(20):
        busy = busy @ busy.T
        busy = busy / busy.norm()
    t.join()
    torch.cuda.synchronize()
    bad = 0
    for k in range(5):
        feats.copy_(torch.randn(b, d, generator=gen, device=dev))
        idx.copy_(torch.randint(0, 5406, (b,), generator=gen, device=dev))
        out["graph"].replay()
        torch.cuda.synchronize()
        bad += int((out["static"] != program()).sum())
    print(json.dumps(dict(graph="captured on a worker thread", replays=5, values_differing=bad)))
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
