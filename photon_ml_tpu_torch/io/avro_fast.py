"""The native route of `read_game_dataset`: block-level decode, streamed assembly.

Port of `photon_ml_tpu/io/avro_fast.py`. The record decode runs in native
code over whole container blocks (native/avro_reader.cc) and Python only
assembles columns: index maps, CSR merges, ELL packing. `compile_native`
decides the route before anything is decoded: it compiles every file's
schema into a native op program, or returns None when one cannot be
expressed, and the caller then reads all files with the Python codec. Once
the route is native, nothing is retried on another route: training ingest
decodes with quarantine, so the native decoder itself skips and counts a
corrupt block (`quarantined_blocks`), as the Python codec's quarantined
read does, and a file whose every block is bad raises. Each file's read
and decode runs under the `decode` fault site with bounded retry of
transient failures, the whole file re-read on each attempt; once the
retries are spent the read raises, naming the file (the reference falls
back to its Python codec there). Each file's read is a `decode_file` trace
span, parented to the reading thread's span.

Files decode on a thread pool (ctypes releases the GIL, and each file's
decode threads over its blocks) and the assembler consumes them in file
order as they land, so the interning of file k overlaps the decode of file
k + 1 and the result does not depend on the timing. Id tags come back
factorized (`tag_codes`: per-sample codes into one sorted value table).
The reference's host CSR stash and background bucketed pack are not
ported: the port builds its sparse layout on the device from the ELL planes
(data/sparse_layout.from_ell), so the `stash` stage reads 0.0.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.data.containers import pack_csr_to_ell
from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap
from photon_ml_tpu_torch.io import avro as avro_io
from photon_ml_tpu_torch.native import avro_reader
from photon_ml_tpu_torch.timing import StageTimes
from photon_ml_tpu_torch.utils import faults, telemetry

logger = logging.getLogger(__name__)

_HEADER_PROBE = 1 << 20


def concat_parts(parts: Sequence[np.ndarray], empty_dtype) -> np.ndarray:
    """Concatenate per-file/per-chunk column parts; a single part is
    returned as is (np.concatenate would copy it)."""
    if not len(parts):
        return np.empty(0, empty_dtype)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


@dataclasses.dataclass(frozen=True)
class CompiledFile:
    path: str
    body_start: int
    codec: str
    sync: bytes
    program: avro_reader.Program


def _read_header(path: str):
    """(schema, codec, sync, body start) from the first MiB of the file, or
    from the whole file when the header is longer than that."""
    with open(path, "rb") as f:
        head = f.read(_HEADER_PROBE)
    try:
        schema, codec, sync, body = avro_io.read_header(head, path)
        if len(sync) == avro_io.SYNC_SIZE and body <= len(head):
            return schema, codec, sync, body
    except (ValueError, KeyError, IndexError):
        if len(head) < _HEADER_PROBE:  # the whole file was read: a bad header
            raise
    with open(path, "rb") as f:
        return avro_io.read_header(f.read(), path)


def bag_names_of(shard_configs) -> List[str]:
    """The feature bags of every shard, each once, in first-use order."""
    names: List[str] = []
    for cfg in shard_configs.values():
        for b in cfg.feature_bags:
            if b not in names:
                names.append(b)
    return names


def compile_native(
    files: Sequence[str],
    shard_configs,
    id_tag_fields: Sequence[str],
    cols,
    label_fallback: str,
) -> Optional[List[CompiledFile]]:
    """One native op program per file, compiled from its header alone; None
    when any file's schema cannot be expressed (the Python route)."""
    bag_names = bag_names_of(shard_configs)
    compiled = []
    for path in files:
        schema, codec, sync, body = _read_header(path)
        program = avro_reader.compile_program(
            schema,
            response=cols.response,
            fallback_label=label_fallback,
            offset=cols.offset,
            weight=cols.weight,
            uid=cols.uid,
            metadata_map=cols.metadata_map,
            bag_names=bag_names,
            tag_fields=tuple(id_tag_fields),
        )
        if program is None:
            return None
        compiled.append(CompiledFile(path, body, codec, sync, program))
    return compiled


class _IngestAssembler:
    """Incremental per-file assembly of decoded columns.

    `add(d)` consumes one file's DecodedFile strictly in file order:
    interning its key dictionary into the global id space, remapping its bag
    keys, and stringifying its tag value table. `finalize()` is the
    order-insensitive tail (concatenations), identical whether the adds were
    interleaved with decode or ran after it."""

    def __init__(self, n_bags: int):
        self.n_bags = n_bags
        self.global_ids: Dict[str, int] = {}
        self.key_list: List[str] = []
        self.labels: List[np.ndarray] = []
        self.offsets: List[np.ndarray] = []
        self.weights: List[np.ndarray] = []
        self.bag_ip: List[List[np.ndarray]] = [[] for _ in range(n_bags)]
        self.bag_keys: List[List[np.ndarray]] = [[] for _ in range(n_bags)]
        self.bag_vals: List[List[np.ndarray]] = [[] for _ in range(n_bags)]
        self.tag_ids: List[np.ndarray] = []
        self.val_tables: List[np.ndarray] = []
        self.n = 0
        self.n_files = 0

    def _global(self, keys: List[str]) -> np.ndarray:
        out = np.empty(len(keys), np.int64)
        global_ids, key_list = self.global_ids, self.key_list
        for i, k in enumerate(keys):
            g = global_ids.get(k)
            if g is None:
                g = len(key_list)
                global_ids[k] = g
                key_list.append(k)
            out[i] = g
        return out

    def add(self, d: avro_reader.DecodedFile) -> None:
        fi = self.n_files
        self.n_files += 1
        self.n += len(d.labels)
        self.labels.append(d.labels)
        self.offsets.append(d.offsets)
        self.weights.append(d.weights)
        # The first file's local ids are the global ids by construction.
        l2g = self._global(d.keys)
        for b in range(self.n_bags):
            self.bag_ip[b].append(d.bag_indptr[b])
            if not len(d.bag_keys[b]):
                self.bag_keys[b].append(np.empty(0, np.int64))
            elif fi == 0:
                self.bag_keys[b].append(d.bag_keys[b])
            else:
                self.bag_keys[b].append(l2g[d.bag_keys[b]])
            self.bag_vals[b].append(d.bag_vals[b])
        self.tag_ids.append(d.tag_ids)
        self.val_tables.append(np.asarray([str(v) for v in d.tag_values] + [""], dtype=object))

    def finalize(self):
        """(labels, offsets, weights, per-bag (indptr, global keys, values))."""
        labels = concat_parts(self.labels, np.float64).astype(np.float32, copy=False)
        offsets = concat_parts(self.offsets, np.float64).astype(np.float32, copy=False)
        weights = concat_parts(self.weights, np.float64).astype(np.float32, copy=False)
        bag_indptr: List[np.ndarray] = []
        bag_gkeys: List[np.ndarray] = []
        bag_vals: List[np.ndarray] = []
        for b in range(self.n_bags):
            if self.n_files == 1:
                bag_indptr.append(self.bag_ip[b][0])
                bag_gkeys.append(self.bag_keys[b][0])
                bag_vals.append(self.bag_vals[b][0])
                continue
            ip_parts = [np.zeros(1, np.int64)]
            off = 0
            for ip in self.bag_ip[b]:
                ip_parts.append(ip[1:] + off)
                off += int(ip[-1])
            bag_indptr.append(np.concatenate(ip_parts))
            bag_gkeys.append(concat_parts(self.bag_keys[b], np.int64))
            bag_vals.append(concat_parts(self.bag_vals[b], np.float32))
        return labels, offsets, weights, bag_indptr, bag_gkeys, bag_vals


def decode_file(c: CompiledFile, n_threads: int, quarantine: bool,
                handoff=None) -> avro_reader.DecodedFile:
    """One file's read and native decode under the `decode` fault site,
    retried on transient failures (the whole file re-read each attempt, so
    a torn read never leaks into a retry), inside a `decode_file` span
    parented through `handoff` (`telemetry.span_handoff()` of the reading
    thread). A corrupt block raises at once, or is quarantined and
    counted; spent retries raise, naming the file."""

    def attempt() -> avro_reader.DecodedFile:
        faults.fault_point("decode")
        with open(c.path, "rb") as f:
            data = f.read()
        return avro_reader.decode_file_native(
            data, c.body_start, c.codec, c.sync, c.program, DELIMITER,
            n_threads=n_threads, path=c.path, quarantine=quarantine)

    try:
        with telemetry.adopt_span(handoff), telemetry.span(
                "decode_file", file=os.path.basename(c.path)):
            out = faults.retry(attempt, label=f"avro decode {c.path}")
    except ValueError:
        raise  # a file the decoder rejects: it names the file already
    except Exception as exc:
        raise RuntimeError(f"{c.path}: Avro read and decode failed after its retries "
                           f"({exc!r})") from exc
    if out.quarantined_blocks:
        faults.COUNTERS.increment("quarantined_blocks", out.quarantined_blocks)
        logger.warning("%s: quarantined %d corrupt block(s)", c.path, out.quarantined_blocks)
    return out


def _decode_all(compiled: Sequence[CompiledFile], asm: _IngestAssembler, times: StageTimes, *,
                quarantine: bool) -> bool:
    """Decode every file into the assembler, in file order; returns whether
    the decode was streamed (several files on a thread pool)."""
    budget = avro_reader.default_threads()
    handoff = telemetry.span_handoff()

    def decode(c: CompiledFile, n_threads: int) -> avro_reader.DecodedFile:
        t0 = time.perf_counter()
        try:
            return decode_file(c, n_threads, quarantine, handoff)
        finally:
            times.record("decode", time.perf_counter() - t0)

    if len(compiled) == 1 or budget == 1:
        for c in compiled:
            out = decode(c, budget)
            with times.stage("assemble"):
                asm.add(out)
        return False
    # At most width + 1 decoded files are resident; the assembler takes them
    # in file order as they land.
    width = min(budget, len(compiled))
    per_file = max(1, budget // width)
    with ThreadPoolExecutor(max_workers=width, thread_name_prefix="photon-ingest-decode") as pool:
        queue: deque = deque()
        pending = list(compiled)
        try:
            while pending or queue:
                while pending and len(queue) <= width:
                    queue.append(pool.submit(decode, pending.pop(0), per_file))
                out = queue.popleft().result()
                with times.stage("assemble"):
                    asm.add(out)
        finally:
            for fut in queue:
                fut.cancel()
    return True


def read_native(
    compiled: Sequence[CompiledFile],
    shard_configs,
    index_maps: Optional[Mapping[str, IndexMap]],
    id_tag_fields: Sequence[str],
    cols,
    uid_tag: str,
    times: StageTimes,
):
    """Decode (corrupt blocks quarantined) and assemble: (shards as CPU ELL
    `SparseFeatures`, labels, offsets, weights, id_tags, tag_codes, index
    maps)."""
    bag_names = bag_names_of(shard_configs)
    asm = _IngestAssembler(len(bag_names))
    streaming = _decode_all(compiled, asm, times, quarantine=True)
    times.note("ingest_path", "native-stream" if streaming else "native")
    times.note("chunks", str(asm.n_files))
    times.note("streaming", "1" if streaming else "0")
    n = asm.n
    if n == 0:
        raise ValueError(f"no records found in {[c.path for c in compiled]}")
    with times.stage("assemble"):
        labels, offsets, weights, bag_indptr, bag_gkeys, bag_vals = asm.finalize()
    key_list = asm.key_list

    # ---- id tags: per-file value tables merge into one sorted table --------
    tag_slots = compiled[0].program.tag_slots
    id_tags: Dict[str, np.ndarray] = {}
    tag_codes: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    with times.stage("tags"):
        all_tag_ids = concat_parts(asm.tag_ids, np.int32)
        val_tables = asm.val_tables
        guniq, ginv = np.unique(np.concatenate(val_tables).astype(str), return_inverse=True)
        tbl_starts = np.cumsum([0] + [len(t) for t in val_tables])
        file_maps = [ginv[tbl_starts[fi]:tbl_starts[fi + 1]] for fi in range(asm.n_files)]
        for slot, tag in enumerate(tag_slots):
            code_parts = []
            for fi, ids_f in enumerate(asm.tag_ids):
                ids = ids_f[:, slot]
                fmap = file_maps[fi]
                code_parts.append(fmap[np.where(ids >= 0, ids, len(fmap) - 1)])
            codes = concat_parts(code_parts, np.int64).astype(np.int64, copy=False)
            col = guniq[codes]
            if tag == cols.uid:
                if bool((all_tag_ids[:, slot] >= 0).any()):
                    id_tags[uid_tag] = col
                    tag_codes[uid_tag] = (codes, guniq)
            else:
                id_tags[tag] = col
                tag_codes[tag] = (codes, guniq)

    # ---- per-shard merge, index maps, ELL pack ------------------------------
    built: Dict[str, IndexMap] = {}
    shards = {}
    bag_index = {b: i for i, b in enumerate(bag_names)}
    key_arr = np.asarray(key_list, dtype=object)
    for shard, cfg in shard_configs.items():
        idxs = [bag_index[b] for b in cfg.feature_bags]
        single_bag = len(idxs) == 1
        if single_bag:
            indptr, gkeys, vals = bag_indptr[idxs[0]], bag_gkeys[idxs[0]], bag_vals[idxs[0]]
        else:
            # Multi-bag union: a stable sort by record reproduces the Python
            # route's order (bags in config order, entries in record order).
            rows = np.concatenate(
                [np.repeat(np.arange(n, dtype=np.int64), np.diff(bag_indptr[i])) for i in idxs])
            gkeys = np.concatenate([bag_gkeys[i] for i in idxs])
            vals = np.concatenate([bag_vals[i] for i in idxs])
            order = np.argsort(rows, kind="stable")
            rows, gkeys, vals = rows[order], gkeys[order], vals[order]
            indptr = np.zeros(n + 1, np.int64)
            np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        # The decoder merges a record's repeated keys within one bag, so a
        # single-bag shard is clean; a key repeated across bags is merged by
        # pack_csr_to_ell.
        clean = single_bag
        present = (np.bincount(gkeys, minlength=len(key_list)).astype(bool) if len(gkeys)
                   else np.zeros(len(key_list), bool))
        present_gids = np.nonzero(present)[0]
        from_data = index_maps is None or shard not in index_maps
        if from_data:
            imap = IndexMap.from_feature_names(set(key_arr[present_gids]),
                                               add_intercept=cfg.has_intercept)
        else:
            imap = index_maps[shard]
        built[shard] = imap
        intercept_idx = imap.intercept_index
        if cfg.has_intercept and intercept_idx is None:
            raise ValueError(
                f"feature shard '{shard}' is configured with an intercept but the index map "
                "has no intercept entry; rebuild it with the intercept key or set "
                "has_intercept=False")
        lut = np.full(len(key_list) + 1, -1, np.int32)
        for gid in present_gids:
            lut[gid] = imap.get_index(key_arr[gid])
        fidx_k = lut[gkeys] if len(gkeys) else np.empty(0, np.int32)
        vals_k = vals.astype(np.float32, copy=False)
        # Drop entries the map does not cover: unseen features under a
        # supplied map, and the intercept key in the data of a shard without
        # an intercept (the Python route drops both; the JAX package's
        # native route keeps the latter as index -1).
        keep = fidx_k >= 0
        if not keep.all():
            cs = np.zeros(len(keep) + 1, np.int64)
            np.cumsum(keep, out=cs[1:])
            indptr = cs[indptr]
            fidx_k = fidx_k[keep]
            vals_k = vals_k[keep]
        # The intercept is one constant ELL column, unless the data carries
        # the intercept key itself (then it is merged like any repeat).
        extra_col = None
        if cfg.has_intercept:
            if clean and not np.any(fidx_k == intercept_idx):
                extra_col = (intercept_idx, 1.0)
            else:
                rows_k = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
                rows_k = np.concatenate([rows_k, np.arange(n, dtype=np.int64)])
                fidx_k = np.concatenate([fidx_k.astype(np.int64), np.full(n, intercept_idx, np.int64)])
                vals_k = np.concatenate([vals_k, np.ones(n, np.float32)])
                order = np.argsort(rows_k, kind="stable")
                rows_k, fidx_k, vals_k = rows_k[order], fidx_k[order], vals_k[order]
                clean = False
                indptr = np.zeros(n + 1, np.int64)
                np.cumsum(np.bincount(rows_k, minlength=n), out=indptr[1:])
        with times.stage("ell"):
            shards[shard] = pack_csr_to_ell(indptr, fidx_k, vals_k, imap.size,
                                            assume_clean=clean, extra_col=extra_col)
    return shards, labels, offsets, weights, id_tags, tag_codes, built
