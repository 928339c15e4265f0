"""Build and load the port's native library with g++.

`avro_reader.cc` (the Avro block decoder), `avro_writer.cc` (the columnar
TrainingExampleAvro writer), `libsvm_parser.cc` (the LibSVM text parser) and
`index_store.cc` (the PHIDX off-heap feature-index store) compile together, at first use, into one shared library in
`photon_ml_tpu_torch/_build/`, named by a hash of the sources
and of the build variant, so an edited source is rebuilt and a stale
library is never loaded. Each process compiles into a temporary file of its
own and moves it into place with `os.replace`, so concurrent first builds
(test workers) cannot interleave.

Deflate containers need zlib. Where g++ can compile and link a probe
against zlib, the library is built with `-DAVRO_WITH_ZLIB -lz`; otherwise
it is built without deflate, null-codec files stay native, and a deflate
file raises a ValueError that names zlib (native/avro_reader.py). Nothing
runs at import time, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
SOURCES = ("avro_reader.cc", "avro_writer.cc", "libsvm_parser.cc", "index_store.cc")
CXX_FLAGS = ("-O2", "-std=c++17", "-pthread", "-shared", "-fPIC")

_LOCK = threading.Lock()
_CDLL: Optional[ctypes.CDLL] = None


def _run(cmd: List[str]) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300)


def have_zlib() -> bool:
    """Can g++ compile and link a program against zlib on this host?"""
    with tempfile.TemporaryDirectory(prefix="photon-zlib-probe-") as tmp:
        src = Path(tmp) / "probe.cc"
        src.write_text("#include <zlib.h>\nint main() { return zlibVersion() == nullptr; }\n")
        proc = _run(["g++", str(src), "-o", str(Path(tmp) / "probe"), "-lz"])
    return proc.returncode == 0


def library_path(with_zlib: bool) -> Path:
    """Where the library for the sources as they stand lives (built or not)."""
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((_DIR / name).read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    variant = "" if with_zlib else "-nozlib"
    return BUILD_DIR / f"libphoton_native-{digest.hexdigest()[:16]}{variant}.so"


def build_library() -> Path:
    """Compile the library if this version of the sources has not been built."""
    with_zlib = have_zlib()
    out = library_path(with_zlib)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(_DIR / s) for s in SOURCES)]
    if with_zlib:
        cmd[1:1] = ["-DAVRO_WITH_ZLIB"]
        cmd.append("-lz")
    proc = _run(cmd)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {out.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """The process-wide handle of the native library, built on demand.
    Binding modules declare their own symbol signatures on it."""
    global _CDLL
    with _LOCK:
        if _CDLL is None:
            _CDLL = ctypes.CDLL(str(build_library()))
        return _CDLL
