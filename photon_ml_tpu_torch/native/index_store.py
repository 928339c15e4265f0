"""Persistent memory-mapped feature-index store (PHIDX format).

The port's copy of `photon_ml_tpu/native/index_store.py`, the counterpart of
the reference's PalDB off-heap index map stack (photon-api
index/PalDBIndexMap.scala:43 load:69-81, PalDBIndexMapBuilder.scala:27,
PalDBIndexMapLoader.scala:25): one logical store = N hash partitions, each
built independently with partition-local indices 0..n-1; the loader resolves
global index = local + cumulative offset (PalDBIndexMap.scala:36-44) and
answers idx -> name by locating the owning partition from the offset table.

The engine is the C++ library (index_store.cc, built by g++ into the port's
one native library at first use, native/build.py): mmap'd, zero-copy
probing. The files are the JAX package's, byte for byte, for the same keys
and partition count. There is no fallback: when the library does not build,
building or opening a store raises. The pure-Python reader and writer of the
same format below are the plain version the tests hold the library against,
reached only by `force_python=True`.

Partition files are named `index-partition-<namespace>-<k>.bin`, mirroring
the reference's `paldb-partition-<namespace>-<k>.dat` convention
(FeatureIndexingDriver.scala writes one per Spark partition).
"""

from __future__ import annotations

import ctypes
import json
import mmap
import os
import struct
from typing import Iterator, List, Optional, Sequence

from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY
from photon_ml_tpu_torch.native.build import load_native

_MAGIC = b"PHIDX001"
_HEADER = 32
_NAME_BUF = 4096
METADATA_FILE = "_index_metadata.json"


def partition_filename(partition: int, namespace: str = "global") -> str:
    """Reference naming: PalDBIndexMap.partitionFilename (paldb-partition-
    <namespace>-<k>.dat), with this engine's prefix and suffix."""
    return f"index-partition-{namespace}-{partition}.bin"


def fnv1a64(data: bytes) -> int:
    """The plain version of the library's 64-bit FNV-1a (bit-identical)."""
    h = 14695981039346656037
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return h


# ---------------------------------------------------------------------------
# ctypes bindings

_CONFIGURED = False


def _lib() -> ctypes.CDLL:
    """The native library with the store's symbols declared; raises when it
    does not build."""
    global _CONFIGURED
    lib = load_native()
    if not _CONFIGURED:
        lib.phidx_build.restype = ctypes.c_int64
        lib.phidx_build.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        lib.phidx_open.restype = ctypes.c_void_p
        lib.phidx_open.argtypes = [ctypes.c_char_p]
        lib.phidx_close.restype = None
        lib.phidx_close.argtypes = [ctypes.c_void_p]
        lib.phidx_size.restype = ctypes.c_int64
        lib.phidx_size.argtypes = [ctypes.c_void_p]
        lib.phidx_get.restype = ctypes.c_int64
        lib.phidx_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.phidx_name.restype = ctypes.c_int64
        lib.phidx_name.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        lib.phidx_hash.restype = ctypes.c_uint64
        lib.phidx_hash.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _CONFIGURED = True
    return lib


def _hasher(force_python: bool):
    """key bytes -> FNV-1a: the library's, or the plain version's."""
    if force_python:
        return fnv1a64
    fn = _lib().phidx_hash
    return lambda key: fn(key, len(key))


def partition_for_key(key: str, num_partitions: int, *, force_python: bool = False) -> int:
    """Route a feature key to its hash partition (HashPartitioner role,
    PalDBIndexMap.scala getIndex routing)."""
    return _hasher(force_python)(key.encode("utf-8")) % num_partitions


# ---------------------------------------------------------------------------
# Builders


def _slot_count_for(n: int) -> int:
    slots = 16
    while slots * 7 < n * 10:
        slots <<= 1
    return slots


def build_partition(path: str, keys: Sequence[str], *, force_python: bool = False) -> None:
    """Write one partition file; key i gets partition-local index i
    (PalDBIndexMapBuilder.put stores both directions; here the reverse table
    is implied by entry order)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    encoded = [k.encode("utf-8") for k in keys]
    if not force_python:
        offsets = (ctypes.c_int64 * (len(encoded) + 1))()
        pos = 0
        for i, e in enumerate(encoded):
            offsets[i] = pos
            pos += len(e)
        offsets[len(encoded)] = pos
        rc = _lib().phidx_build(path.encode(), b"".join(encoded), offsets, len(encoded))
        if rc != 0:
            raise OSError(f"phidx_build failed with code {rc} for {path}")
        return
    n = len(encoded)
    num_slots = _slot_count_for(n)
    slot_table = [0] * num_slots
    entry_offsets: List[int] = []
    data_size = 0
    for e in encoded:
        entry_offsets.append(data_size)
        data_size += 8 + len(e)
    for i, e in enumerate(encoded):
        slot = fnv1a64(e) & (num_slots - 1)
        while slot_table[slot] != 0:
            slot = (slot + 1) & (num_slots - 1)
        slot_table[slot] = entry_offsets[i] + 1
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<QQQ", n, num_slots, data_size))
        f.write(struct.pack(f"<{num_slots}Q", *slot_table))
        for i, e in enumerate(encoded):
            f.write(struct.pack("<II", len(e), i))
            f.write(e)
        if n:
            f.write(struct.pack(f"<{n}Q", *entry_offsets))


# ---------------------------------------------------------------------------
# Readers


class _NativePartition:
    """One mmap'd partition through the library."""

    def __init__(self, path: str):
        self._lib = _lib()
        self._handle = self._lib.phidx_open(path.encode())
        if not self._handle:
            raise OSError(f"cannot open index partition {path} (missing, truncated or corrupt)")
        self.size = int(self._lib.phidx_size(self._handle))
        self._buf = ctypes.create_string_buffer(_NAME_BUF)

    def get(self, key: bytes) -> int:
        return int(self._lib.phidx_get(self._handle, key, len(key)))

    def name(self, local_idx: int) -> Optional[str]:
        n = self._lib.phidx_name(self._handle, local_idx, self._buf, _NAME_BUF)
        if n < 0:
            return None
        if n > _NAME_BUF:  # a rare oversized key: again with its exact size
            buf = ctypes.create_string_buffer(int(n))
            self._lib.phidx_name(self._handle, local_idx, buf, n)
            return buf.raw[:n].decode("utf-8")
        return self._buf.raw[:n].decode("utf-8")

    def close(self) -> None:
        if self._handle:
            self._lib.phidx_close(self._handle)
            self._handle = None


class _PyPartition:
    """The plain version: a pure-Python mmap reader of the same format."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        if len(self._mm) < _HEADER or self._mm[:8] != _MAGIC:
            self.close()
            raise OSError(f"bad magic in {path}")
        self.size, self._num_slots, self._data_size = struct.unpack_from("<QQQ", self._mm, 8)
        self._slots_off = _HEADER
        self._entries_off = _HEADER + 8 * self._num_slots
        self._reverse_off = self._entries_off + self._data_size
        # The library's corruption guards: probing masks with num_slots - 1,
        # and the sections must account for the whole file.
        expect = self._reverse_off + 8 * self.size
        if self._num_slots == 0 or self._num_slots & (self._num_slots - 1) or expect != len(self._mm):
            self.close()
            raise OSError(f"corrupt index partition {path}")

    def get(self, key: bytes) -> int:
        if self.size == 0:
            return -1
        mask = self._num_slots - 1
        slot = fnv1a64(key) & mask
        for _ in range(self._num_slots):
            (tagged,) = struct.unpack_from("<Q", self._mm, self._slots_off + 8 * slot)
            if tagged == 0:
                return -1
            e = self._entries_off + tagged - 1
            klen, idx = struct.unpack_from("<II", self._mm, e)
            if klen == len(key) and self._mm[e + 8 : e + 8 + klen] == key:
                return idx
            slot = (slot + 1) & mask
        return -1

    def name(self, local_idx: int) -> Optional[str]:
        if not 0 <= local_idx < self.size:
            return None
        (entry_off,) = struct.unpack_from("<Q", self._mm, self._reverse_off + 8 * local_idx)
        e = self._entries_off + entry_off
        (klen,) = struct.unpack_from("<I", self._mm, e)
        return self._mm[e + 8 : e + 8 + klen].decode("utf-8")

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._f.close()


def open_partition(path: str, *, force_python: bool = False):
    """One partition through the library (raises when it does not build),
    or through the plain version when `force_python`."""
    return _PyPartition(path) if force_python else _NativePartition(path)


class PartitionedIndexStore:
    """Multi-partition reader implementing the IndexMap protocol
    (photon-api index/IndexMap.scala:22: getIndex/getFeatureName/size).

    Global index = partition-local index + cumulative offset, exactly the
    reference's offset-array scheme (PalDBIndexMap.scala load:69-81,
    getFeatureName binary search)."""

    def __init__(self, store_dir: str, namespace: str = "global", *, force_python: bool = False):
        self._hash = _hasher(force_python)
        self._partitions = []
        self._offsets: List[int] = []
        size = 0
        while True:
            path = os.path.join(store_dir, partition_filename(len(self._partitions), namespace))
            if not os.path.exists(path):
                break
            self._offsets.append(size)
            part = open_partition(path, force_python=force_python)
            self._partitions.append(part)
            size += part.size
        if not self._partitions:
            raise FileNotFoundError(f"no index partitions for namespace {namespace!r} in {store_dir}")
        # The build metadata, when present: a missing partition file would
        # otherwise silently truncate the store.
        meta_path = os.path.join(store_dir, METADATA_FILE)
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                expected = json.load(f).get("num_partitions")
            if expected is not None and expected != len(self._partitions):
                self.close()
                raise OSError(
                    f"index store {store_dir} namespace {namespace!r}: found "
                    f"{len(self._offsets)} partition files but metadata says {expected}")
        self._size = size

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    @property
    def size(self) -> int:
        return self._size

    def __len__(self) -> int:
        return self._size

    def __contains__(self, name: str) -> bool:
        return self.get_index(name) >= 0

    def get_index(self, name: str, default: int = -1) -> int:
        key = name.encode("utf-8")
        p = self._hash(key) % len(self._partitions)
        local = self._partitions[p].get(key)
        return local + self._offsets[p] if local >= 0 else default

    def __getitem__(self, name: str) -> int:
        idx = self.get_index(name)
        if idx < 0:
            raise KeyError(name)
        return idx

    def get_feature_name(self, index: int) -> Optional[str]:
        if not 0 <= index < self._size:
            return None
        # The owning partition: the last offset <= index.
        lo, hi = 0, len(self._offsets) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._offsets[mid] <= index:
                lo = mid
            else:
                hi = mid - 1
        return self._partitions[lo].name(index - self._offsets[lo])

    def __iter__(self) -> Iterator[str]:
        for name, _ in self.items():
            yield name

    def items(self):
        for i in range(self._size):
            name = self.get_feature_name(i)
            if name is not None:
                yield name, i

    @property
    def intercept_index(self) -> Optional[int]:
        idx = self.get_index(INTERCEPT_KEY)
        return idx if idx >= 0 else None

    def save(self, path: str) -> None:
        """Export as the JSON name->index map (IndexMap.save's file), so a
        model directory stays self-contained when it was trained against an
        off-heap store."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(self.items()), f)

    def close(self) -> None:
        for p in self._partitions:
            p.close()
        self._partitions = []

    def __enter__(self) -> "PartitionedIndexStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_partitioned_store(
    store_dir: str,
    keys: Sequence[str],
    num_partitions: int,
    namespace: str = "global",
    *,
    force_python: bool = False,
) -> int:
    """Distribute distinct keys over hash partitions and build every
    partition file (the FeatureIndexingDriver core, see cli/build_index.py).
    Keys are sorted within a partition for determinism. Returns total keys."""
    os.makedirs(store_dir, exist_ok=True)
    hash_fn = _hasher(force_python)
    buckets: List[List[str]] = [[] for _ in range(num_partitions)]
    for key in set(keys):
        buckets[hash_fn(key.encode("utf-8")) % num_partitions].append(key)
    for k, bucket in enumerate(buckets):
        bucket.sort()
        build_partition(os.path.join(store_dir, partition_filename(k, namespace)), bucket,
                        force_python=force_python)
    # Drop stale partitions of an earlier build with more partitions: the
    # loader finds partitions by probing file names and would otherwise mix
    # old local indices into the new store.
    k = num_partitions
    while os.path.exists(stale := os.path.join(store_dir, partition_filename(k, namespace))):
        os.remove(stale)
        k += 1
    return sum(len(b) for b in buckets)
