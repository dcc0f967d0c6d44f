"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes``.  The library lands in
``build/repro_torch/`` at the repository root, named by the hash of its
source, so an edited source is rebuilt at its first use and an unchanged
one is loaded as built.  ``build_many`` starts one ``nvcc`` per source at
once, so the build takes as long as the slowest source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
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


def build_many(sources) -> list[Path]:
    """Compile every ``csrc/<source>`` that has no library of the same hash,
    one ``nvcc`` process per source, all running at once."""
    started = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        started.append((source, out, tmp, cmd, proc))
    failed = []
    for source, out, tmp, cmd, proc in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
            continue
        build_logs[source] = err
        os.replace(tmp, out)             # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(s) for s in sources]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless a library of the same hash exists."""
    return build_many([source])[0]


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc/<source>``, once per process."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build(source)))
    return _loaded[source]


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?(\w+)'?")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict[str, dict]:
    """Per-kernel registers and spill bytes from ``nvcc -Xptxas -v`` output:
    ``{mangled name: {"registers": int, "spill_stores": int,
    "spill_loads": int}}``."""
    out: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = out.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = _SPILL.search(line)
        if m:
            current["spill_stores"] = int(m.group(1))
            current["spill_loads"] = int(m.group(2))
        m = _REGS.search(line)
        if m:
            current["registers"] = int(m.group(1))
    return out
