"""Run one program on W ranks, one spawned process each.

Port of the launcher role of `photon_ml_tpu/parallel/multihost.py:328
dryrun_multihost`: `launch(fn, W, backend=..., devices=..., deadline_s=...)`
starts W processes with `torch.multiprocessing` (spawn), joins them into one
process group over a `FileStore` in a temporary directory, and calls
`fn(mesh, *args)` on every rank with its `RankMesh` (parallel/mesh.py). It
returns each rank's return value, by rank. `fn` is a module-level function;
its arguments are pickled (CPU tensors in them travel as shared memory, so
every rank reads the same host arrays without a copy each), and its return
value is pickled by value, so it outlives the rank. Return host values
(numpy arrays, CPU tensors, numbers).

The caller names the backend and every rank's device: `cuda:r` for a card
each (gloo or NCCL), `cuda:0` on every rank for ranks that share one card
(gloo), or `cpu` (gloo). If a rank fails or exits, or the deadline passes,
the others are killed and `launch` raises. `init_process_group` gets a
timeout of the deadline's length, so a rank stuck in a collective fails
rather than hangs.

`torchrun` users call `parallel.mesh.rank_mesh_from_env` in their own
program instead.
"""

from __future__ import annotations

import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from photon_ml_tpu_torch.parallel.mesh import BACKENDS, init_rank_mesh


def _rank_main(rank: int, world_size: int, backend: str, device: str, store_path: str,
               timeout_s: float, fn: Callable, args: tuple, results) -> None:
    mesh = init_rank_mesh(backend=backend, rank=rank, world_size=world_size, device=device,
                          store=dist.FileStore(store_path, world_size), timeout_s=timeout_s)
    try:
        out = fn(mesh, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # By value: a tensor handed over as shared memory would need this
    # process alive while the launcher maps it.
    results.put((rank, True, pickle.dumps(out)))
    mesh.close()


def launch(
    fn: Callable,
    world_size: int,
    *,
    backend: str,
    devices: Sequence[str],
    deadline_s: float,
    args: tuple = (),
) -> List[object]:
    """`fn(mesh, *args)` on `world_size` ranks; the list of their return
    values, by rank. Raises if any rank fails or the deadline passes."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    if backend == "nccl" and len(set(devices)) != world_size:
        raise ValueError("NCCL ranks need a card each; ranks that share a card use gloo")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="photon-ranks-") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, name=f"photon-rank-{r}", daemon=True,
                             args=(r, world_size, backend, str(devices[r]), store_path,
                                   deadline_s, fn, tuple(args), results))
                 for r in range(world_size)]
        end = time.monotonic() + deadline_s
        try:
            for p in procs:
                p.start()
            # Drain results while waiting: a rank cannot exit before its
            # result has left its queue.
            while len(out) < world_size:
                if time.monotonic() > end:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did "
                                       f"not finish within {deadline_s} s")
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    gone = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                    if gone:
                        raise RuntimeError(f"rank {gone[0]} exited with code "
                                           f"{procs[gone[0]].exitcode} before returning")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = pickle.loads(value)
            for p in procs:
                p.join(max(end - time.monotonic(), 0.1))
            late = [r for r, p in enumerate(procs) if p.is_alive() or p.exitcode != 0]
            if late:
                raise RuntimeError(f"rank {late[0]} did not exit cleanly after returning "
                                   f"(exit code {procs[late[0]].exitcode})")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
            results.close()
    return [out[r] for r in range(world_size)]
