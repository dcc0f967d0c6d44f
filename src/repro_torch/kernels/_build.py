"""Build and load the hand-written CUDA kernels.

A ``Library`` is a shared library with a plain C interface, loaded with
``ctypes``, built from one or more sources under ``csrc/``: ``nvcc``
compiles each source to an object, and the objects are linked into
``build/repro_torch/<name>-<hash>.so`` at the repository root.  The hash
covers the library's sources, every header beside them and the flags, so
an edited source is rebuilt at its first use and an unchanged library is
loaded as built.  ``build_many`` starts one ``nvcc`` per source of every
library at once, so the build takes about as long as the slowest source.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Library:
    """A shared library built from ``sources``, names under ``csrc``."""
    name: str
    sources: tuple[str, ...]


_loaded: dict[Library, ctypes.CDLL] = {}     # library -> loaded library
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


def library_path(lib: Library) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".h", ".cuh"))
    for name in (*lib.sources, *headers):
        digest.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    return BUILD_DIR / f"{lib.name}-{digest.hexdigest()[:16]}.so"


def build_many(libs) -> list[Path]:
    """Build every library that has no ``.so`` of the same hash: one
    ``nvcc -c`` per source, all running at once, then one link each."""
    pending, started = [], []
    for lib in libs:
        out = library_path(lib)
        if out.exists():
            continue
        objdir = out.with_suffix(f".{os.getpid()}.obj")
        objdir.mkdir(parents=True, exist_ok=True)
        objs = []
        for source in lib.sources:
            obj = objdir / f"{Path(source).stem}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            started.append((source, cmd, proc))
            objs.append(obj)
        pending.append((out, objdir, objs))
    failed = []
    for source, cmd, proc in started:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
        else:
            build_logs[source] = err
    for out, objdir, objs in pending:
        if not failed:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append(f"linking {out.name} failed:\n{' '.join(cmd)}\n"
                              f"{proc.stderr}")
            else:
                os.replace(tmp, out)     # atomic: a reader never sees half a file
        shutil.rmtree(objdir, ignore_errors=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(lib) for lib in libs]


def load(lib: Library) -> ctypes.CDLL:
    """Build (if needed) and load ``lib``, once per process."""
    if lib not in _loaded:
        _loaded[lib] = ctypes.CDLL(str(build_many([lib])[0]))
    return _loaded[lib]


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
