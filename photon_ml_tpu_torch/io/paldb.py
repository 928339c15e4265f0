"""PalDB v1 stores — the reference's off-heap feature-index format.

The port's copy of `photon_ml_tpu/io/paldb.py` (its reader, writer and
loaders; pure Python, no JAX there either). Stores written here are the
JAX package's byte for byte for the same entries and timestamp.

The reference distributes feature index maps as PalDB partitions
(`paldb-partition-<shard>-<n>.dat`, written by PalDBIndexMapBuilder.scala:27
via `com.linkedin.paldb:paldb:1.1.0` and read back memory-mapped by
PalDBIndexMap.scala:43-118). Each store holds BOTH directions — feature name
→ integer id AND id → name (PalDBIndexMapBuilder.put:59-62) — and a
multi-partition map offsets each partition's internal ids by the cumulative
`size/2` of its predecessors (PalDBIndexMap.load:88-96).

This module decodes the on-disk format (reverse-engineered from the
reference's own fixture stores and validated against their known contents;
see tests/test_paldb.py and tests/test_torch_paldb.py):

    writeUTF("PALDB_V1") | long timestamp | int keyCount
    int keyLengthCount | int maxKeyLength
    per serialized-key-length: int keyLength, int keyCount, int slotCount,
        int slotSize, int indexOffset, long dataOffset
    long indexGlobalOffset | long dataGlobalOffset
    ... index section: per length, slotCount slots of
        [serialized key (keyLength bytes)][LSB base-128 varint data offset,
         zero-padded to slotSize]  (all-zero key bytes = empty slot)
    ... data section: per length group, a reserved 0x00 at offset 0, then
        entries [varint length][serialized value]

Value/key serialization (the subset PalDB's index maps use):
    int:    codes 0x05..0x0D encode 0..8 directly; 0x0E + raw byte encodes
            9..254; 0x10 + LSB base-128 varint encodes larger values
    string: 'g' + varint(byteCount) + utf-8 bytes (feature keys carry the
            reference's embedded name/term delimiter \x01, trailing for
            empty terms)

Only whole-store loading is implemented (the framework keeps index maps
in-memory / in its own mmap store); random access hashing is unnecessary.
"""

from __future__ import annotations

import os
import re
import struct
import time
from typing import Dict, List, Optional, Tuple, Union

from photon_ml_tpu_torch.data.index_map import DELIMITER, IndexMap, feature_key
from photon_ml_tpu_torch.native.index_store import PartitionedIndexStore

MAGIC = "PALDB_V1"

Key = Union[int, str]


def _read_varint(b: bytes, pos: int) -> Tuple[int, int]:
    """LSB base-128 varint (high bit = continuation)."""
    shift = 0
    out = 0
    while True:
        c = b[pos]
        pos += 1
        out |= (c & 0x7F) << shift
        if not c & 0x80:
            return out, pos
        shift += 7


def _decode(b: bytes, pos: int) -> Tuple[Key, int]:
    """Decode one serialized key/value at `pos`."""
    c = b[pos]
    if 0x05 <= c <= 0x0D:
        return c - 5, pos + 1
    if c == 0x0E:
        return b[pos + 1], pos + 2
    if c == 0x10:
        return _read_varint(b, pos + 1)
    if c == ord("g"):
        n, pos = _read_varint(b, pos + 1)
        s = b[pos : pos + n].decode("utf-8")
        return s, pos + n
    raise ValueError(f"unsupported PalDB serialization code 0x{c:02x} at {pos}")


def read_store(path: str) -> Dict[Key, Key]:
    """Load every (key, value) pair of one PalDB partition file."""
    with open(path, "rb") as f:
        b = f.read()
    ulen = struct.unpack(">H", b[:2])[0]
    if b[2 : 2 + ulen].decode() != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} store")
    off = 2 + ulen + 8  # skip timestamp
    key_count, klc, _max_kl = struct.unpack(">iii", b[off : off + 12])
    off += 12
    entries = []
    for _ in range(klc):
        kl, kc, slots, slot_size, idx_off = struct.unpack(">iiiii", b[off : off + 20])
        off += 20
        data_off = struct.unpack(">q", b[off : off + 8])[0]
        off += 8
        entries.append((kl, kc, slots, slot_size, idx_off, data_off))
    idx_abs, data_abs = struct.unpack(">qq", b[off : off + 16])

    out: Dict[Key, Key] = {}
    for kl, kc, slots, slot_size, idx_off, data_off in entries:
        base = idx_abs + idx_off
        group = data_abs + data_off
        found = 0
        for s in range(slots):
            slot = b[base + s * slot_size : base + (s + 1) * slot_size]
            if not any(slot[:kl]):
                continue  # empty slot
            key, _ = _decode(slot, 0)
            rel, _ = _read_varint(slot, kl)
            vlen, vpos = _read_varint(b, group + rel)
            value, _ = _decode(b, vpos)
            out[key] = value
            found += 1
        if found != kc:
            raise ValueError(
                f"{path}: key-length {kl} group decoded {found} of {kc} keys"
            )
    if len(out) != key_count:
        raise ValueError(f"{path}: decoded {len(out)} of {key_count} keys")
    return out


# ---------------------------------------------------------------- writer
#
# The write side of the same format, so index stores built by this framework
# are loadable by the reference's PalDBIndexMap (PalDBIndexMap.scala:43-118
# via com.linkedin.paldb:paldb:1.1.0) — closing the one remaining one-way
# format door (the reader above has consumed the reference's stores since
# r2). Layout facts were reverse-engineered from the reference's own fixture
# stores and are byte-validated in tests/test_paldb.py:
#
#   * slot placement: murmur3_32(keyBytes, seed=42) & 0x7FFFFFFF, modulo the
#     group's slot count, linear probing in insertion order (verified against
#     all 30k keys of the GameIntegTest shard1 store);
#   * slots per group: Math.round(keyCount / 0.75);
#   * slotSize: keyLength + byte length of the largest data-offset varint in
#     the group;
#   * per-group data streams start with one reserved 0x00 so offset 0 never
#     addresses a real entry; entries are [varint valueLen][value bytes] in
#     insertion order;
#   * int serialization: 0x05+v for 0..8, 0x0E + raw byte for 9..254,
#     0x10 + LSB varint for >=255 (all three observed in the fixtures).


def _murmur3_32(data: bytes, seed: int = 42) -> int:
    """MurmurHash3 x86 32-bit — PalDB's HashUtils slot hash (seed 42)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(key: Key) -> bytes:
    if isinstance(key, bool):
        raise TypeError("bool is not a PalDB index-map key type")
    if isinstance(key, int):
        if key < 0:
            raise ValueError("negative ids are not used by index maps")
        if key <= 8:
            return bytes([0x05 + key])
        if key <= 254:
            return bytes([0x0E, key])
        return bytes([0x10]) + _write_varint(key)
    b = str(key).encode("utf-8")
    return bytes([ord("g")]) + _write_varint(len(b)) + b


def java_string_hash(s: str) -> int:
    """java.lang.String.hashCode over UTF-16 code units, wrapped to int32.

    PalDBIndexMap routes lookups with `new HashPartitioner(n)` on the raw
    key string (PalDBIndexMap.scala:79,145-151), so multi-partition writes
    must split features exactly this way.
    """
    h = 0
    units = s.encode("utf-16-be")
    for i in range(0, len(units), 2):
        h = (31 * h + int.from_bytes(units[i : i + 2], "big")) & 0xFFFFFFFF
    return h - 0x100000000 if h >= 0x80000000 else h


def _nonneg_mod(x: int, n: int) -> int:
    r = x % n
    return r + n if r < 0 else r


def java_partition(s: str, n: int) -> int:
    """Spark HashPartitioner.getPartition: non-negative hashCode mod n."""
    return _nonneg_mod(java_string_hash(s), n)


def write_store(
    path: str,
    entries,
    timestamp_ms: Optional[int] = None,
) -> None:
    """Write one PalDB v1 partition file from (key, value) pairs in
    insertion order (the order defines both data layout and linear-probe
    displacement, matching paldb's StorageWriter)."""
    groups: Dict[int, dict] = {}
    total = 0
    for k, v in entries:
        kb = _encode(k)
        vb = _encode(v)
        g = groups.setdefault(
            len(kb), {"keys": [], "data": bytearray(b"\x00")}
        )
        rel = len(g["data"])
        g["data"] += _write_varint(len(vb)) + vb
        g["keys"].append((kb, rel))
        total += 1

    if timestamp_ms is None:
        timestamp_ms = int(time.time() * 1000)

    kls = sorted(groups)
    # Per group: slots = Math.round(count / 0.75); slotSize = keyLength +
    # widest offset varint; place keys by murmur hash with linear probing.
    index_blobs = []
    data_blobs = []
    table = []
    idx_off = 0
    data_off = 0
    for kl in kls:
        g = groups[kl]
        count = len(g["keys"])
        slots = int(count / 0.75 + 0.5)  # Java Math.round
        slot_size = kl + max(len(_write_varint(rel)) for _, rel in g["keys"])
        blob = bytearray(slots * slot_size)
        for kb, rel in g["keys"]:
            s = (_murmur3_32(kb) & 0x7FFFFFFF) % slots
            for _ in range(slots):
                start = s * slot_size
                if not any(blob[start : start + kl]):
                    blob[start : start + kl] = kb
                    off_bytes = _write_varint(rel)
                    blob[start + kl : start + kl + len(off_bytes)] = off_bytes
                    break
                s = (s + 1) % slots
            else:
                raise RuntimeError("hash table overflow (corrupt slot count)")
        table.append((kl, count, slots, slot_size, idx_off, data_off))
        index_blobs.append(bytes(blob))
        data_blobs.append(bytes(g["data"]))
        idx_off += len(blob)
        data_off += len(g["data"])

    out = bytearray()
    magic = MAGIC.encode()
    out += struct.pack(">H", len(magic)) + magic
    out += struct.pack(">q", timestamp_ms)
    out += struct.pack(">iii", total, len(kls), max(kls) if kls else 0)
    for kl, count, slots, slot_size, io_, do in table:
        out += struct.pack(">iiiii", kl, count, slots, slot_size, io_)
        out += struct.pack(">q", do)
    header_len = len(out) + 16
    out += struct.pack(">qq", header_len, header_len + idx_off)
    for blob in index_blobs:
        out += blob
    for blob in data_blobs:
        out += blob
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_index_map(
    store_dir: str,
    shard: str,
    feature_names,
    num_partitions: int = 1,
) -> Dict[str, int]:
    """Build PalDB partition stores for a feature set, returning the
    name -> global id mapping the layout defines.

    Mirrors FeatureIndexingDriver's structure (partition by the key
    string's Java hashCode mod n — FeatureIndexingDriver.scala:251 via
    HashPartitioner — local ids 0.. within each partition in insertion
    order, global id = local + cumulative predecessor sizes as
    PalDBIndexMap.load:88-96 reconstructs) but with a DETERMINISTIC
    insertion order (sorted feature keys) instead of Spark shuffle order.
    Keys are stored in the reference's name+DELIMITER+term form (trailing
    delimiter for empty terms).
    """
    os.makedirs(store_dir, exist_ok=True)
    parts: List[List[str]] = [[] for _ in range(num_partitions)]
    for key in feature_names:
        stored = key if DELIMITER in key else key + DELIMITER
        parts[java_partition(stored, num_partitions)].append(stored)

    mapping: Dict[str, int] = {}
    offset = 0
    for pid, keys in enumerate(parts):
        keys.sort()
        entries = []
        for local, stored in enumerate(keys):
            entries.append((stored, local))
            entries.append((local, stored))
        write_store(
            os.path.join(store_dir, f"paldb-partition-{shard}-{pid}.dat"),
            entries,
        )
        for local, stored in enumerate(keys):
            n_, _, t_ = stored.partition(DELIMITER)
            mapping[feature_key(n_, t_)] = local + offset
        offset += len(keys)
    return mapping


def lookup(path_bytes: bytes, key: Key) -> Optional[Key]:
    """Emulate paldb StorageReader.get(): hash -> slot -> linear probe ->
    data offset -> value. Used by tests to certify that stores written by
    `write_store` resolve every key the way the reference's reader would."""
    b = path_bytes
    ulen = struct.unpack(">H", b[:2])[0]
    off = 2 + ulen + 8
    key_count, klc, _ = struct.unpack(">iii", b[off : off + 12])
    off += 12
    table = []
    for _ in range(klc):
        kl, kc, slots, ss, io_ = struct.unpack(">iiiii", b[off : off + 20])
        off += 20
        do = struct.unpack(">q", b[off : off + 8])[0]
        off += 8
        table.append((kl, kc, slots, ss, io_, do))
    ia, da = struct.unpack(">qq", b[off : off + 16])
    kb = _encode(key)
    for kl, kc, slots, ss, io_, do in table:
        if kl != len(kb):
            continue
        base = ia + io_
        s = (_murmur3_32(kb) & 0x7FFFFFFF) % slots
        for _ in range(slots):
            slot = b[base + s * ss : base + (s + 1) * ss]
            if not any(slot[:kl]):
                return None  # empty slot terminates the probe
            if bytes(slot[:kl]) == kb:
                rel, _ = _read_varint(slot, kl)
                vlen, vpos = _read_varint(b, da + do + rel)
                value, _ = _decode(b, vpos)
                return value
            s = (s + 1) % slots
        return None
    return None


def partition_files(store_dir: str, shard: str) -> List[str]:
    """The shard's partition files in partition order
    (PalDBIndexMapLoader's `paldb-partition-<shard>-<n>.dat`).

    Matching is exact on the shard name with a strictly numeric partition
    suffix — a glob would let shard 'global' swallow 'global-v2' partitions
    (corrupting the id space via wrong offsets) or trip over stray
    non-numeric .dat files."""
    pat = re.compile(rf"paldb-partition-{re.escape(shard)}-(\d+)\.dat$")
    if not os.path.isdir(store_dir):
        return []
    matches = []
    for name in os.listdir(store_dir):
        m = pat.fullmatch(name)
        if m:
            matches.append((int(m.group(1)), os.path.join(store_dir, name)))
    return [p for _, p in sorted(matches)]


def resolve_offheap_index_maps(store_dir: str, shards):
    """Per-shard index maps from an off-heap store directory, auto-detecting
    the reference's PalDB partitions vs this framework's PHIDX partitions
    (prepareFeatureMaps, GameDriver.scala:231-236). Shared by the training
    and scoring drivers so format detection cannot drift between them."""
    out = {}
    for shard in shards:
        if partition_files(store_dir, shard):
            out[shard] = load_index_map(store_dir, shard)
        else:
            out[shard] = PartitionedIndexStore(store_dir, shard)
    return out


def load_index_map(store_dir: str, shard: str):
    """Load a shard's PalDB partitions into an in-memory IndexMap.

    Mirrors PalDBIndexMap.load:88-96: partition i's internal ids are
    offset by the cumulative size/2 of partitions 0..i-1, making global ids
    unique. Both stored directions are cross-checked.
    """
    paths = partition_files(store_dir, shard)
    if not paths:
        raise FileNotFoundError(
            f"no paldb-partition-{shard}-*.dat files under {store_dir}"
        )
    name_to_id: Dict[str, int] = {}
    offset = 0
    for p in paths:
        store = read_store(p)
        id_to_name = {k: v for k, v in store.items() if isinstance(k, int)}
        names = {k: v for k, v in store.items() if isinstance(k, str)}
        if len(id_to_name) != len(names):
            raise ValueError(f"{p}: asymmetric id/name entries")
        for name, internal in names.items():
            # Cross-check the reverse direction the builder wrote.
            if id_to_name.get(internal) != name:
                raise ValueError(f"{p}: id->name mismatch for {name!r}")
            # Reference keys are always name+DELIMITER+term (trailing
            # delimiter for empty terms); normalize to this framework's
            # feature_key convention (bare name when the term is empty).
            n_, _, t_ = name.partition(DELIMITER)
            name_to_id[feature_key(n_, t_)] = internal + offset
        offset += len(names)
    return IndexMap(name_to_id)
