"""ctypes binding of the native LibSVM parser (libsvm_parser.cc).

The port's own copy of `photon_ml_tpu/native/libsvm_parser.py`. The
library is built on demand by native/build.py (a failed build raises).
`parse_file` returns raw CSR arrays, or None when the parser refuses the
file (malformed input, an unreadable path); `data/libsvm.read_libsvm` then
hands the file to its Python tokenizer, as the JAX reader does, so the
error a malformed file raises comes from one place.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from photon_ml_tpu_torch.native.build import load_native

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = load_native()
            lib.phsvm_parse.restype = ctypes.c_void_p
            lib.phsvm_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
            for fn in (lib.phsvm_rows, lib.phsvm_nnz, lib.phsvm_max_index):
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p]
            lib.phsvm_copy.restype = None
            lib.phsvm_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.phsvm_free.restype = None
            lib.phsvm_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
        return _LIB


def parse_file(
    path: str, *, zero_based: bool = False
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]]:
    """(labels f64, indptr i64, indices i32, values f64, max_index), or None
    when the parser refuses the file."""
    lib = _lib()
    handle = lib.phsvm_parse(path.encode("utf-8"), 1 if zero_based else 0)
    if not handle:
        return None
    try:
        rows = lib.phsvm_rows(handle)
        nnz = lib.phsvm_nnz(handle)
        labels = np.empty(rows, np.float64)
        indptr = np.empty(rows + 1, np.int64)
        indices = np.empty(nnz, np.int32)
        values = np.empty(nnz, np.float64)
        lib.phsvm_copy(
            handle,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return labels, indptr, indices, values, int(lib.phsvm_max_index(handle))
    finally:
        lib.phsvm_free(handle)
