"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in `photon_ml_tpu_torch/csrc/` is compiled on its own into a
shared library with a plain C interface, at first use, into
`photon_ml_tpu_torch/_build/`. A library is named by a hash of its source
and of every header in `csrc/`, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs at import time, and nothing
falls back: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[Path, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(source: Path) -> Path:
    """Where the library for `source` as it stands lives (built or not)."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build_library(source: Path, verbose: bool = False) -> Tuple[Path, str]:
    """Compile `source` if this version of it has not been built yet.

    Returns (library path, compiler log); `verbose` adds `-Xptxas -v`, whose
    per-kernel register, shared-memory and spill lines land in the log."""
    out = library_path(source)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    return out, proc.stdout + proc.stderr


def load_library(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of `source` (built first if needed); `bind` sets
    the argtypes and restype of every function it exports, once."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build_library(source)
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _loaded[source] = lib
    return lib


def check_rc(rc: int, what: str, error_string: Callable[[int], bytes]) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        msg = error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
