"""Fault-tolerant checkpointing: atomic, checksummed, async, keep-last-k,
copied from the JAX package's ``repro/runtime/checkpoint.py`` with its
on-disk layout, so a checkpoint written by either package restores in the
other.

Layout per step::

    <dir>/step_<N>/arrays.npz     flattened param/opt tree, "/"-joined key paths
    <dir>/step_<N>/manifest.json  shapes, dtypes, sha256 per leaf, metadata
    <dir>/step_<N>/COMMITTED      written last -- absence marks a torn save

Saves stage into ``step_<N>.tmp`` and ``os.replace`` to commit, so a crash
mid-write can never corrupt the latest checkpoint.  ``restore_latest``
walks checkpoints newest-first and falls back past torn or corrupt ones
(checksum mismatch), the failure-recovery path.  bf16 leaves are stored as
fp32, which holds them exactly.

Under a mesh the leaves are DTensors.  A save gathers each leaf whole on
every rank (a collective: every rank calls ``save``) and only the primary
rank writes; a restore given a mesh and placements reads the full arrays on
every rank and keeps each rank's shards, so a checkpoint restores onto any
mesh (``runtime/elastic.py``).
"""
from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import shutil
import struct
import time
import zipfile
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import ParamSpec
from repro_torch.runtime.elastic import reshard_tree
from repro_torch.runtime.tree import flatten, unflatten


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf``, taken now: the train step updates its
    tensors in place, and an async save writes them after later steps
    (JAX arrays are immutable, so the reference needs no copy)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if isinstance(leaf, DTensor):              # gather it whole
            leaf = leaf.full_tensor()
        if leaf.dtype == torch.bfloat16:
            # npz has no bfloat16; f32 holds bf16 exactly.  Widened on the
            # host: the card copies half the bytes and makes no fp32 copy
            return leaf.cpu().float().numpy()
        return leaf.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in flatten(tree)}


def _sha(a: np.ndarray) -> str:
    # the array's own buffer, not a ``tobytes`` copy (the digest is the same)
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


def _hasher() -> cf.ThreadPoolExecutor:
    """Threads, up to the host's cores, that hash leaves while the npz is
    written or read (hashlib lets go of the GIL): a full-width Yi-6B
    checkpoint holds 24.2 GB of arrays."""
    return cf.ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _npz_arrays(path):
    """(key, array) for each member of the npz at ``path``, as ``np.load``
    names and reads them.  Each member, stored as ``np.savez`` stores it
    (both packages' checkpoints), is read by numpy's own reader straight
    from the file, one read an array, where ``np.load`` reads it through
    ``zipfile`` 256 KB at a time (with the checksums, 42 s for a
    full-width Yi-6B checkpoint's 24.5 GB on an H100's host).  Its CRC is
    not checked here; the manifest's sha256 is, as before.  A compressed
    member is refused."""
    with zipfile.ZipFile(path) as zf:
        infos = zf.infolist()
    with open(path, "rb") as f:
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; a checkpoint "
                                 "stores its arrays")
            # the member's data follows its local header: 30 bytes, then
            # the name and an extra field of the lengths at bytes 26-29
            f.seek(info.header_offset + 26)
            name, extra = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name + extra)
            key = info.filename
            yield key[:-4] if key.endswith(".npy") else key, np.lib.format.read_array(f)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, async_save: bool = True,
                 primary: bool = True):
        """``primary``: whether this rank writes (one rank of a mesh does)."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.primary = primary
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: cf.Future | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, extra: dict | None = None):
        """Snapshot to host memory now; write (possibly async) afterwards."""
        arrays = _flatten(tree)                       # sync device->host
        if not self.primary:
            return
        if self._pool is not None:
            self.wait()
            self._pending = self._pool.submit(
                self._write, step, arrays, extra or {})
        else:
            self._write(step, arrays, extra or {})

    def _write(self, step: int, arrays: dict, extra: dict):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        with _hasher() as pool:
            shas = {k: pool.submit(_sha, v) for k, v in arrays.items()}
            np.savez(tmp / "arrays.npz", **arrays)
            shas = {k: f.result() for k, f in shas.items()}
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                           "sha256": shas[k]} for k, v in arrays.items()},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "COMMITTED").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def _load(self, step: int, verify: bool = True):
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        arrays, shas = {}, {}
        with _hasher() as pool:
            for k, a in _npz_arrays(d / "arrays.npz"):
                arrays[k] = a
                if verify and k in manifest["leaves"]:
                    shas[k] = pool.submit(_sha, a)
        if verify:
            for k, info in manifest["leaves"].items():
                if k not in shas or shas[k].result() != info["sha256"]:
                    raise IOError(f"checksum mismatch in {d}/{k}")
        return arrays, manifest

    def restore_latest(self, target_tree, *, device="cpu", verify=True,
                       max_step: int | None = None, mesh=None, placements=None):
        """Newest valid checkpoint -> (tree, manifest); falls back on corrupt.

        ``target_tree`` gives the tree's structure and each leaf's dtype
        (leaves may be ParamSpecs or tensors); the restored tensors are put
        on ``device``, and with ``placements`` (a tree like the target's, as
        ``sharding.spec_shardings`` gives) distributed onto ``mesh``.
        ``max_step`` bounds the search (failure recovery must not resume
        "from the future" of the failed step).
        """
        steps = [s for s in self.all_steps()
                 if max_step is None or s <= max_step]
        for step in reversed(steps):
            try:
                arrays, manifest = self._load(step, verify)
                tree = self._unflatten(target_tree, arrays, device)
            except Exception as e:  # noqa: BLE001 -- any torn/corrupt state
                print(f"[ckpt] step {step} unusable "
                      f"({type(e).__name__}: {e}); trying previous")
                continue
            if placements is not None:
                tree = reshard_tree(tree, placements, mesh=mesh)
            return tree, manifest
        raise FileNotFoundError(f"no valid checkpoint under {self.dir}")

    @staticmethod
    def _unflatten(target_tree, arrays, device):
        out = []
        for key, leaf in flatten(target_tree):
            a = arrays[key]
            shape = tuple(leaf.shape)
            if a.shape != shape:
                raise ValueError(f"{key}: shape {a.shape}, expected {shape}")
            dtype = leaf.torch_dtype if isinstance(leaf, ParamSpec) else leaf.dtype
            # np.ascontiguousarray would give a 0-d leaf (a step count) a dim
            out.append(torch.from_numpy(np.asarray(a, order="C")).to(
                device=device, dtype=dtype))
        return unflatten(target_tree, out)
