"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library lands in
``build/repro_torch/`` at the repository root, named by the hash of its
source, so an edited source is rebuilt at its first use and an unchanged
one is loaded as built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}     # source name -> loaded library
build_logs: dict[str, str] = {}     # source name -> nvcc's report (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; "
                           "the CUDA kernels cannot be built")
    return str(path)


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    build_logs[source] = proc.stderr
    os.replace(tmp, out)                 # atomic: a reader never sees half a file
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<source>``, once per process."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]
