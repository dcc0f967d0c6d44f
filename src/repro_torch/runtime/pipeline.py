"""Deterministic data pipeline for LM training, copied from the JAX
package's ``repro/runtime/pipeline.py``.

Host-side token stream -> packed fixed-length sequences -> batches laid out
as [microbatches, batch, seq], as tensors on the pipeline's device.  A
background thread keeps ``prefetch`` batches in flight so host data work
overlaps device compute.

The synthetic corpus is a seeded Zipfian token source, with documents of
random length separated by EOS and *packed* -- no padding waste; the same
seed gives the same tokens as the JAX package's pipeline, bit for bit.

One difference: the JAX pipeline's ``state()`` is the producer's cursor, up
to ``prefetch`` batches ahead of what was consumed, so a run resumed from
it skips those batches.  Here each queued batch carries the cursor after
it, ``state()`` is the cursor after the last batch handed out, and
``restore()`` stops the producer, drops what it queued and restarts it: a
resumed run sees exactly the batches an uninterrupted one would.  Without
the thread (``start()`` not called) the two pipelines' states agree.

Under a mesh every rank builds the same global batch and keeps its shards:
with ``mesh`` and ``placements`` (``sharding.spec_shardings`` of the
step's batch specs) each batch comes out as DTensors, as the JAX pipeline
places its batches by ``sharding``.  A re-mesh sets both anew.
"""
from __future__ import annotations

import copy
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class PipelineConfig:
    seed: int = 0
    prefetch: int = 2
    mean_doc_len: int = 512
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Seeded, restartable document stream (stand-in for a corpus reader)."""

    def __init__(self, vocab: int, cfg: PipelineConfig, start_doc: int = 0):
        self.vocab = vocab
        self.cfg = cfg
        self.doc_index = start_doc

    def next_doc(self) -> np.ndarray:
        # per-document RNG keyed by (seed, doc_index): deterministic resume
        rng = np.random.default_rng((self.cfg.seed, self.doc_index))
        self.doc_index += 1
        n = max(8, int(rng.exponential(self.cfg.mean_doc_len)))
        toks = rng.zipf(self.cfg.zipf_a, size=n) % (self.vocab - 2)
        return toks.astype(np.int32) + 2                 # 0=pad, 1=eos


class PackedBatcher:
    """Pack documents into fixed-length rows with EOS separators."""

    def __init__(self, corpus: SyntheticCorpus, seq_len: int):
        self.corpus = corpus
        self.seq_len = seq_len
        self._buf = np.zeros(0, np.int32)

    def next_rows(self, n_rows: int) -> np.ndarray:
        need = n_rows * self.seq_len
        parts = [self._buf]
        have = len(self._buf)
        while have < need:
            doc = self.corpus.next_doc()
            parts.append(doc)
            parts.append(np.array([1], np.int32))        # eos
            have += len(doc) + 1
        flat = np.concatenate(parts)
        self._buf = flat[need:]
        return flat[:need].reshape(n_rows, self.seq_len)

    def state(self) -> dict:
        return {"doc_index": self.corpus.doc_index,
                "buf": self._buf.tolist()}

    def restore(self, state: dict) -> None:
        self.corpus.doc_index = state["doc_index"]
        self._buf = np.asarray(state["buf"], np.int32)


class DataPipeline:
    """Batches shaped [m, b, ...] with a prefetch thread; checkpointable."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 pcfg: PipelineConfig = PipelineConfig(), device="cpu", *,
                 mesh=None, placements=None):
        self.cfg = model_cfg
        self.shape = shape
        self.pcfg = pcfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.placements = placements
        self.batcher = PackedBatcher(
            SyntheticCorpus(model_cfg.vocab, pcfg), shape.seq_len)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, pcfg.prefetch))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = 0
        self._consumed = self._cursor()

    # -------------------------------------------------------------- build
    def _build(self) -> dict:
        m = self.cfg.train_microbatches
        b = self.shape.global_batch // m
        t = self.shape.seq_len
        t_text = t - (self.cfg.image_tokens if self.cfg.frontend == "vision" else 0)
        if self.cfg.n_codebooks > 1:
            rows = self.batcher.next_rows(m * b * self.cfg.n_codebooks)
            toks = rows.reshape(m, b, self.cfg.n_codebooks, t_text)
        else:
            rows = self.batcher.next_rows(m * b)[:, :t_text]
            toks = rows.reshape(m, b, t_text)
        batch = {"tokens": toks}
        if self.cfg.frontend == "vision":
            rng = np.random.default_rng((self.pcfg.seed, 10_000_019, self._step))
            batch["image_embeds"] = rng.normal(
                0, 0.02, (m, b, self.cfg.image_tokens, self.cfg.d_model)
            ).astype(np.float32)
        self._step += 1
        return batch

    def _cursor(self) -> dict:
        return {"batcher": self.batcher.state(), "step": self._step}

    def _put_device(self, batch):
        out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in batch.items()}
        if self.placements is None:
            return out
        from repro_torch.runtime.sharding import distribute_tree
        return distribute_tree(out, self.mesh, self.placements)

    # ------------------------------------------------------------ iterate
    def _worker(self, stop: threading.Event):
        while not stop.is_set():
            if self._pending is None:
                batch = self._build()
                self._pending = (batch, self._cursor())
            try:
                self._q.put(self._pending, timeout=0.2)
                self._pending = None
            except queue.Full:
                continue

    def start(self):
        if self._thread is None:
            self._stop = threading.Event()
            self._pending = None
            self._thread = threading.Thread(target=self._worker,
                                            args=(self._stop,), daemon=True)
            self._thread.start()
        return self

    def __next__(self):
        if self._thread is None:
            batch = self._build()
            self._consumed = self._cursor()
        else:
            batch, self._consumed = self._q.get()
        return self._put_device(batch)

    def __iter__(self):
        return self

    def stop(self):
        """Stop the producer and drop what it built ahead; the cursor goes
        back to the last batch handed out, so nothing is skipped."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
            while not self._q.empty():
                self._q.get_nowait()
            self._set_cursor(self._consumed)

    # --------------------------------------------------------- checkpoint
    def state(self) -> dict:
        """The cursor after the last batch handed out."""
        return copy.deepcopy(self._consumed)

    def restore(self, state: dict) -> None:
        running = self._thread is not None
        self.stop()
        self._set_cursor(state)
        if running:
            self.start()

    def _set_cursor(self, state: dict) -> None:
        self.batcher.restore(state["batcher"])
        self._step = state["step"]
        self._consumed = self._cursor()
