"""dislib-style blocked distributed array, the port of the JAX package's
``repro/data/distarray.py``.

A ``DistArray`` is an (n x m) matrix hybrid-partitioned into a
``p_r x p_c`` grid of blocks (paper §II: hybrid static partitioning).  The
blocks are tensors on one device; the block edges (``row_edges``,
``col_edges``) stay numpy integers on the host, because the master reads
them.  All algorithm-level operations are per-block *tasks* submitted to a
``TaskExecutor`` (see executor.py), mirroring dislib's ds-array on top of
PyCOMPSs.
"""
from __future__ import annotations

import numpy as np
import torch


def _stitch(*bs):
    return torch.cat(bs, dim=1)


class DistArray:
    def __init__(self, blocks, shape):
        self.blocks = blocks                 # list[list[torch.Tensor]]
        self.shape = tuple(shape)
        self.p_r = len(blocks)
        self.p_c = len(blocks[0])
        rows = np.cumsum([0] + [r[0].shape[0] for r in blocks])
        cols = np.cumsum([0] + [b.shape[1] for b in blocks[0]])
        self.row_edges = rows
        self.col_edges = cols

    @property
    def device(self) -> torch.device:
        return self.blocks[0][0].device

    def split_rows(self, y):
        """Split a per-row vector along this array's row partitioning."""
        return [y[self.row_edges[i]:self.row_edges[i + 1]]
                for i in range(self.p_r)]

    # ------------------------------------------------------------ creation
    @classmethod
    def from_array(cls, x: torch.Tensor, p_r: int, p_c: int) -> "DistArray":
        n, m = x.shape
        if not (1 <= p_r <= n and 1 <= p_c <= m):
            raise ValueError(f"cannot split {tuple(x.shape)} into "
                             f"{p_r} x {p_c} blocks")
        row_edges = np.linspace(0, n, p_r + 1).astype(int)
        col_edges = np.linspace(0, m, p_c + 1).astype(int)
        blocks = [[x[row_edges[i]:row_edges[i + 1],
                     col_edges[j]:col_edges[j + 1]].contiguous()
                   for j in range(p_c)] for i in range(p_r)]
        return cls(blocks, (n, m))

    def to_array(self) -> torch.Tensor:
        return torch.cat([torch.cat(row, dim=1) for row in self.blocks],
                         dim=0)

    def refine(self, factor_r: int = 1, factor_c: int = 1) -> "DistArray":
        """Derive a ``(p_r*factor_r) x (p_c*factor_c)`` grid by splitting the
        existing blocks into views (``narrow``) -- no re-slicing of the
        source array and no data copies.

        The new edges follow the same global ``linspace`` convention as
        ``from_array``, so a refined array is block-for-block identical to
        one partitioned from scratch.  If a finer edge set does not nest
        inside the current one (possible only for non-uniform factor/shape
        combinations), falls back to re-partitioning the assembled array.
        """
        if factor_r == 1 and factor_c == 1:
            return self
        n, m = self.shape
        new_pr, new_pc = self.p_r * factor_r, self.p_c * factor_c
        if not (1 <= new_pr <= n and 1 <= new_pc <= m):
            raise ValueError(f"cannot refine {self.shape} into "
                             f"{new_pr} x {new_pc} blocks")
        row_edges = np.linspace(0, n, new_pr + 1).astype(int)
        col_edges = np.linspace(0, m, new_pc + 1).astype(int)
        # owning coarse block of each fine block's start edge
        ri = np.searchsorted(self.row_edges, row_edges[:-1], "right") - 1
        cj = np.searchsorted(self.col_edges, col_edges[:-1], "right") - 1
        nested = (np.all(self.row_edges[ri + 1] >= row_edges[1:])
                  and np.all(self.col_edges[cj + 1] >= col_edges[1:]))
        if not nested:                     # fine block straddles a coarse edge
            return DistArray.from_array(self.to_array(), new_pr, new_pc)
        blocks = [[self.blocks[ri[i]][cj[j]]
                   .narrow(0, int(row_edges[i] - self.row_edges[ri[i]]),
                           int(row_edges[i + 1] - row_edges[i]))
                   .narrow(1, int(col_edges[j] - self.col_edges[cj[j]]),
                           int(col_edges[j + 1] - col_edges[j]))
                   for j in range(new_pc)] for i in range(new_pr)]
        return DistArray(blocks, self.shape)

    # ------------------------------------------------------------ helpers
    @property
    def block_shape(self):
        return tuple(self.blocks[0][0].shape)

    def block_sizes_mb(self):
        return [[b.numel() * b.element_size() / 2**20 for b in row]
                for row in self.blocks]

    def row_stitched(self, executor=None, defer: bool = False):
        """Concatenate column blocks per row block (a real task when the
        algorithm needs whole feature rows, e.g. RF / CSVM).

        With ``defer=True`` returns one future per row block without
        forcing a schedule, so downstream per-block tasks chain off their
        own stitch and overlap under the DAG scheduler.  Without it the
        call is a barrier: the executor collects the whole pending graph
        (including any unrelated futures submitted earlier).
        """
        if self.p_c == 1:
            return [row[0] for row in self.blocks]
        if executor is None:
            return [torch.cat(row, dim=1) for row in self.blocks]
        fs = [executor.submit(_stitch, *row, name="stitch")
              for row in self.blocks]
        if defer:
            return fs
        return executor.collect(*fs)

    def map_blocks(self, fn) -> "DistArray":
        return DistArray([[fn(b) for b in row] for row in self.blocks],
                         self.shape)
