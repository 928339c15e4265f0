"""ctypes binding + schema->op-program compiler for the native Avro decoder.

Port of `photon_ml_tpu/native/avro_reader.py`. `compile_program` inspects a
parsed Avro record schema (Python owns the type system) and emits the flat
op stream avro_reader.cc executes; a schema it cannot express compiles to
None, and the caller reads those files with the Python codec instead (a
route chosen before any decoding). `decode_file_native` raises on any file
the decoder rejects, or with `quarantine=True` skips and counts its corrupt
blocks itself: nothing is retried on another route.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from photon_ml_tpu_torch.native.build import load_native

# Record ops (keep in sync with avro_reader.cc).
NUM_COL, NUM_COL_P, TAG, TAG_P = 1, 2, 3, 4
FEATURES, META, SKIP, SKIP_P, SKIP_MAP, SKIP_FARR = 5, 6, 7, 8, 9, 10
FNAME, FTERM, FTERM_P, FVALUE, FVALUE_P = 20, 21, 22, 23, 24

# Value kinds (numeric contexts coerce; see avro_reader.cc header).
_KINDS = {
    "null": 0,
    "double": 1,
    "float": 2,
    "int": 3,
    "long": 3,
    "boolean": 4,
    "string": 5,
    "bytes": 5,
}


def _norm(t):
    """Normalize a schema type: unwrap {"type": primitive} annotations."""
    if isinstance(t, dict) and isinstance(t.get("type"), str) and t["type"] in _KINDS:
        return t["type"]
    return t


def _type_of(field: dict):
    t = field["type"]
    if isinstance(t, list):
        return [_norm(b) for b in t]
    return _norm(t)


def _kinds_of(t) -> Optional[List[int]]:
    """Kind list for a primitive-or-union type, else None."""
    branches = t if isinstance(t, list) else [t]
    out = []
    for b in branches:
        b = _norm(b)
        if not isinstance(b, str) or b not in _KINDS:
            return None
        out.append(_KINDS[b])
    return out


def _is_map(t) -> bool:
    return isinstance(t, dict) and t.get("type") == "map"


@dataclasses.dataclass(frozen=True)
class Program:
    record_ops: np.ndarray  # int32
    feature_ops: np.ndarray  # int32
    bag_names: Tuple[str, ...]
    tag_slots: Tuple[str, ...]  # tag name per slot; the uid slot is LAST
    n_meta_tags: int = 0  # leading slots the metadataMap fallback may fill


def _numeric_ops(op_u: int, op_p: int, head: List[int], t) -> Optional[List[int]]:
    kinds = _kinds_of(t)
    if kinds is None:
        return None
    if isinstance(t, list):
        return [op_u] + head + [len(kinds)] + kinds
    return [op_p] + head + kinds


def _skip_ops(t, resolve=lambda x: x) -> Optional[List[int]]:
    """SKIP/SKIP_P/SKIP_MAP/SKIP_FARR ops for an ignored field."""
    kinds = _kinds_of(t)
    if kinds is not None:
        if isinstance(t, list):
            return [SKIP, len(kinds)] + kinds
        return [SKIP_P] + kinds
    # nullable wrappers
    nullable = 0
    inner = t
    if isinstance(t, list) and len(t) == 2 and _norm(t[0]) == "null":
        nullable, inner = 1, _norm(t[1])
    if _is_map(inner):
        vkinds = _kinds_of(
            [_norm(b) for b in inner["values"]]
            if isinstance(inner["values"], list)
            else _norm(inner["values"])
        )
        if vkinds is None:
            return None
        return [SKIP_MAP, nullable, len(vkinds)] + vkinds
    if isinstance(inner, dict) and inner.get("type") == "array":
        item = resolve(inner.get("items"))
        if not isinstance(item, dict) or item.get("type") != "record":
            return None
        sub: List[int] = []
        for f in item.get("fields", ()):
            s = _skip_ops(_type_of(f), resolve)
            if s is None or s[0] not in (SKIP, SKIP_P):
                return None
            sub += s
        return [SKIP_FARR, nullable, len(sub)] + sub
    return None


def _compile_feature_ops(item) -> Optional[List[int]]:
    if not isinstance(item, dict) or item.get("type") != "record":
        return None
    ops: List[int] = []
    seen_name = False
    for f in item.get("fields", ()):
        t = _type_of(f)
        name = f["name"]
        if name == "name" and t == "string":
            ops.append(FNAME)
            seen_name = True
        elif name == "term":
            if not seen_name:
                return None  # key concatenation needs name first
            kinds = _kinds_of(t)
            if t == "string":
                ops.append(FTERM_P)
            elif (
                isinstance(t, list)
                and kinds is not None
                and all(k in (0, 1, 5) for k in kinds)
                and 5 in kinds
            ):
                # Branches: null -> bare name, string -> name+delim+term.
                # (numeric term branches unsupported)
                if any(k == 1 for k in kinds):
                    return None
                # C++ FTERM string kind id is 1.
                ops += [FTERM, len(kinds)] + [1 if k == 5 else k for k in kinds]
            else:
                return None
        elif name == "value":
            nops = _numeric_ops(FVALUE, FVALUE_P, [], t)
            if nops is None:
                return None
            ops += nops
        else:
            s = _skip_ops(t)
            if s is None or s[0] not in (SKIP, SKIP_P):
                return None
            ops += s
    if FNAME not in ops or not any(o in (FVALUE, FVALUE_P) for o in ops):
        return None
    return ops


def compile_program(
    schema,
    *,
    response: str,
    fallback_label: str,
    offset: str,
    weight: str,
    uid: str,
    metadata_map: str,
    bag_names: Sequence[str],
    tag_fields: Sequence[str],
) -> Optional[Program]:
    """Compile a record schema into the native op program, or None."""
    if not isinstance(schema, dict) or schema.get("type") != "record":
        return None
    fields = schema.get("fields")
    if not fields:
        return None
    field_names = [f["name"] for f in fields]
    label_field = response if response in field_names else fallback_label

    # Tag slots: requested tags first, then uid (captured for the UID tag).
    # Only the requested tags are eligible for the metadataMap fallback —
    # the Python path never reads uid from the map. A uid field requested as
    # an explicit tag would need one slot with two fallback semantics; that
    # corner stays on the Python path.
    if any("." in t for t in tag_fields):
        return None  # dotted map-column paths stay on the Python path
    if uid in tag_fields:
        return None
    tag_slots = tuple(tag_fields) + (uid,)
    slot_of = {t: i for i, t in enumerate(tag_slots)}

    bag_names = tuple(bag_names)
    bag_slot = {b: i for i, b in enumerate(bag_names)}

    # Named-type registry: arrays later in the schema may reference an
    # earlier record definition by (fully qualified) name, e.g.
    # {"items": "com.linkedin...Feature"}.
    named: Dict[str, dict] = {}

    def _register(t) -> None:
        if isinstance(t, dict):
            if t.get("type") == "record" and t.get("name"):
                ns = t.get("namespace") or schema.get("namespace")
                named[t["name"]] = t
                if ns:
                    named[f"{ns}.{t['name']}"] = t
                for sub in t.get("fields", ()):
                    _register(sub.get("type"))
            elif t.get("type") == "array":
                _register(t.get("items"))
            elif t.get("type") == "map":
                _register(t.get("values"))
        elif isinstance(t, list):
            for b in t:
                _register(b)

    for f in fields:
        _register(f.get("type"))

    def _resolve(t):
        if isinstance(t, str) and t in named:
            return named[t]
        return t

    ops: List[int] = []
    feature_ops: Optional[List[int]] = None
    for f in fields:
        name = f["name"]
        t = _type_of(f)
        target = {label_field: 1, offset: 2, weight: 3}.get(name)
        if target is not None:
            nops = _numeric_ops(NUM_COL, NUM_COL_P, [target], t)
            if nops is None:
                return None
            ops += nops
        elif name in bag_slot:
            nullable = 0
            inner = t
            if isinstance(t, list) and len(t) == 2 and _norm(t[0]) == "null":
                nullable, inner = 1, _norm(t[1])
            if not (isinstance(inner, dict) and inner.get("type") == "array"):
                return None
            fops = _compile_feature_ops(_resolve(inner.get("items")))
            if fops is None:
                return None
            if feature_ops is None:
                feature_ops = fops
            elif feature_ops != fops:
                return None  # bags with different item layouts: Python path
            ops += [FEATURES, bag_slot[name], nullable]
        elif name == metadata_map:
            nullable = 0
            inner = t
            if isinstance(t, list) and len(t) == 2 and _norm(t[0]) == "null":
                nullable, inner = 1, _norm(t[1])
            if _is_map(inner) and _norm(inner.get("values")) == "string":
                ops += [META, nullable]
            else:
                s = _skip_ops(t, _resolve)
                if s is None:
                    return None
                ops += s
        elif name in slot_of:
            kinds = _kinds_of(t)
            # Only null/string/integer tag branches stringify identically to
            # Python's str(value); bool/float tags stay on the Python path.
            if kinds is None or any(k not in (0, 5, 3) for k in kinds):
                return None
            # kind 5 covers bytes too, whose str() differs — require string.
            branches = t if isinstance(t, list) else [t]
            if any(_norm(b) == "bytes" for b in branches):
                return None
            kinds = [1 if k == 5 else k for k in kinds]  # tag string kind = 1
            if isinstance(t, list):
                ops += [TAG, slot_of[name], len(kinds)] + kinds
            else:
                ops += [TAG_P, slot_of[name]] + kinds
        else:
            s = _skip_ops(t, _resolve)
            if s is None:
                return None
            ops += s
    if feature_ops is None and bag_names:
        return None  # none of the requested bags exist in this schema
    return Program(
        record_ops=np.asarray(ops, np.int32),
        feature_ops=np.asarray(feature_ops or [], np.int32),
        bag_names=bag_names,
        tag_slots=tag_slots,
        n_meta_tags=len(tag_fields),
    )


@dataclasses.dataclass
class DecodedFile:
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    bag_indptr: List[np.ndarray]
    bag_keys: List[np.ndarray]
    bag_vals: List[np.ndarray]
    keys: List[str]  # interned key id -> string
    tag_ids: np.ndarray  # (n_records, n_tags) int32, -1 absent
    tag_values: List[str]
    # Per bag, informational: did any record carry the same feature key
    # twice? Duplicates are ACCUMULATED at decode time (dedup_row), so the
    # returned bags are always per-record clean regardless of this flag.
    bag_has_dups: List[bool] = dataclasses.field(default_factory=list)
    # Corrupt blocks skipped whole (a quarantined decode; 0 when strict).
    quarantined_blocks: int = 0


class _CResult(ctypes.Structure):
    _fields_ = [
        ("n_records", ctypes.c_int64),
        ("labels", ctypes.POINTER(ctypes.c_double)),
        ("offsets", ctypes.POINTER(ctypes.c_double)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
        ("n_bags", ctypes.c_int32),
        ("bag_indptr", ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))),
        ("bag_keys", ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))),
        ("bag_vals", ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ("bag_nnz", ctypes.POINTER(ctypes.c_int64)),
        ("bag_has_dups", ctypes.POINTER(ctypes.c_int32)),
        ("n_keys", ctypes.c_int64),
        ("key_bytes", ctypes.POINTER(ctypes.c_char)),
        ("key_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_tags", ctypes.c_int32),
        ("tag_ids", ctypes.POINTER(ctypes.c_int32)),
        ("n_tag_vals", ctypes.c_int64),
        ("tag_val_bytes", ctypes.POINTER(ctypes.c_char)),
        ("tag_val_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_blocks", ctypes.c_int64),
        ("n_quarantined", ctypes.c_int64),
    ]


_CONFIGURED = False


def _lib() -> ctypes.CDLL:
    global _CONFIGURED
    lib = load_native()
    if not _CONFIGURED:
        lib.photon_avro_decode.restype = ctypes.c_void_p
        lib.photon_avro_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.photon_avro_free.restype = None
        lib.photon_avro_free.argtypes = [ctypes.c_void_p]
        lib.photon_avro_has_deflate.restype = ctypes.c_int32
        lib.photon_avro_has_deflate.argtypes = []
        i64p, dp = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)
        lib.photon_avro_decode_scores.restype = ctypes.c_int64
        lib.photon_avro_decode_scores.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, dp, dp, dp,
            ctypes.POINTER(ctypes.c_uint8), i64p,
        ]
        _CONFIGURED = True
    return lib


def has_deflate() -> bool:
    """Does the native library decode deflate containers (built with zlib)?"""
    return bool(_lib().photon_avro_has_deflate())


def _strings(byte_ptr, offsets_ptr, n: int) -> List[str]:
    if n == 0:
        return []
    offs = np.ctypeslib.as_array(offsets_ptr, shape=(n + 1,))
    total = int(offs[n])
    raw = ctypes.string_at(byte_ptr, total)
    return [raw[offs[i] : offs[i + 1]].decode("utf-8") for i in range(n)]


def default_threads() -> int:
    """Decode worker count: the cores this process may run on."""
    return len(os.sched_getaffinity(0))


def decode_file_native(
    data: bytes,
    body_start: int,
    codec: str,
    sync: bytes,
    program: Program,
    delimiter: str,
    n_threads: Optional[int] = None,
    path: str = "<bytes>",
    quarantine: bool = False,
) -> DecodedFile:
    """Decode one whole container file (`data`) with `program`; raises
    ValueError on an unsupported codec and on a deflate file when the
    library was built without zlib. Strict (the default), any block the
    decoder rejects raises. With `quarantine`, a block that fails its
    framing, sync marker, inflate or decode is skipped whole (the walk
    re-synchronizes at the next sync marker, as io/avro.iter_container
    does) and counted in `quarantined_blocks`; a file whose every block is
    bad still raises. Counting into the process counters is the caller's."""
    lib = _lib()
    codec_id = {"null": 0, "deflate": 1}.get(codec)
    if codec_id is None:
        raise ValueError(f"{path}: unsupported codec {codec!r}")
    if codec_id == 1 and not has_deflate():
        raise ValueError(f"{path}: a deflate container, and the native Avro library was built "
                         "without zlib (no zlib headers or library on this host)")
    rops = program.record_ops
    fops = program.feature_ops
    tag_names_joined = b"".join(t.encode("utf-8") + b"\x00" for t in program.tag_slots)
    handle = lib.photon_avro_decode(
        data,
        len(data),
        body_start,
        codec_id,
        sync,
        rops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(rops),
        fops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(fops),
        len(program.bag_names),
        tag_names_joined,
        len(program.tag_slots),
        program.n_meta_tags,
        delimiter.encode("utf-8"),
        default_threads() if n_threads is None else n_threads,
        1 if quarantine else 0,
    )
    if not handle:
        raise ValueError(f"{path}: the native Avro decoder rejected the file (a corrupt or "
                         "truncated block, a bad sync marker, or a value the schema forbids)")
    try:
        c = ctypes.cast(handle, ctypes.POINTER(_CResult)).contents
        n = int(c.n_records)
        n_bad, n_blocks = int(c.n_quarantined), int(c.n_blocks)
        if n_bad and n_bad == n_blocks:
            raise ValueError(f"{path}: all {n_blocks} block(s) are corrupt")
        out = DecodedFile(
            labels=np.ctypeslib.as_array(c.labels, shape=(n,)).copy(),
            offsets=np.ctypeslib.as_array(c.offsets, shape=(n,)).copy(),
            weights=np.ctypeslib.as_array(c.weights, shape=(n,)).copy(),
            bag_indptr=[
                np.ctypeslib.as_array(c.bag_indptr[b], shape=(n + 1,)).copy()
                for b in range(c.n_bags)
            ],
            bag_keys=[
                np.ctypeslib.as_array(
                    c.bag_keys[b], shape=(max(int(c.bag_nnz[b]), 1),)
                )[: int(c.bag_nnz[b])].copy()
                for b in range(c.n_bags)
            ],
            bag_vals=[
                np.ctypeslib.as_array(
                    c.bag_vals[b], shape=(max(int(c.bag_nnz[b]), 1),)
                )[: int(c.bag_nnz[b])].copy()
                for b in range(c.n_bags)
            ],
            keys=_strings(c.key_bytes, c.key_offsets, int(c.n_keys)),
            tag_ids=np.ctypeslib.as_array(
                c.tag_ids, shape=(max(n * int(c.n_tags), 1),)
            )[: n * int(c.n_tags)].copy().reshape(n, int(c.n_tags)),
            tag_values=_strings(c.tag_val_bytes, c.tag_val_offsets, int(c.n_tag_vals)),
            bag_has_dups=[bool(c.bag_has_dups[b]) for b in range(c.n_bags)],
            quarantined_blocks=n_bad,
        )
    finally:
        lib.photon_avro_free(handle)
    return out


@dataclasses.dataclass
class ScoreBlock:
    """One block of ScoringResultAvro records, decoded column-wise. Null
    labels and weights read 0.0; `present` bits: 1 uid, 2 label, 4 weight."""

    scores: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    present: np.ndarray
    uids: List[Optional[str]]


def decode_scores_block(data: bytes, count: int, path: str = "<bytes>") -> ScoreBlock:
    """Decode `count` ScoringResultAvro records from one inflated block;
    raises ValueError on a block that does not hold them, or that holds a
    metadataMap."""
    scores, labels, weights = (np.zeros(count, np.float64) for _ in range(3))
    present = np.zeros(count, np.uint8)
    uid_spans = np.zeros((count, 2), np.int64)
    dp = ctypes.POINTER(ctypes.c_double)
    rc = _lib().photon_avro_decode_scores(
        data, len(data), count, scores.ctypes.data_as(dp), labels.ctypes.data_as(dp),
        weights.ctypes.data_as(dp), present.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        uid_spans.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc == -2:
        raise ValueError(f"{path}: a score record with a metadataMap, which the port does not read")
    if rc < 0:
        raise ValueError(f"{path}: a block that does not decode as ScoringResultAvro records")
    uids = [data[a:a + n].decode("utf-8") if has else None
            for (a, n), has in zip(uid_spans.tolist(), ((present & 1) > 0).tolist())]
    return ScoreBlock(scores, labels, weights, present, uids)
