#!/usr/bin/env python3
"""What is live when a dry-run cell reaches its peak on a rank.

    PYTHONPATH=src python3 tools/dryrun_peak.py hymba-1.5b prefill_32k [--top 25]

Builds the cell on ``pod16x16`` as ``python -m repro_torch dryrun`` does
(a fake group of 512 ranks, meta locals, this process as rank 0), runs its
step once under the dry-run's ``RankTrace``, and prints the peak of live
temp storage (the record's ``temp_size_in_bytes``) with the largest storages
live at that moment: each one's shape, dtype and the model frames that made
it.  A tensor kept alive by a view shows here at the size of its base.
Needs only a host, like the dry-run.
"""
from __future__ import annotations

import argparse
import traceback

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh


class PeakTrace(dryrun.RankTrace):
    """``RankTrace`` that notes where each storage was made and, at each new
    peak, the largest live storages."""

    def __init__(self, args, top: int):
        super().__init__(args)
        self.top, self.origin, self.at_peak = top, {}, []

    def _track(self, outs):
        where = None
        for x in outs:
            key = x.untyped_storage()._cdata
            if key in self._args or key in self._held:
                continue
            if where is None:
                frames = [f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
                          for f in traceback.extract_stack()
                          if "repro_torch/models" in f.filename]
                where = " < ".join(reversed(frames[-4:]))
            self.origin[key] = (list(x.shape), str(x.dtype)[6:], where)
        before = self.peak
        super()._track(outs)
        if self.peak > before:
            self.at_peak = sorted(((n, self.origin.get(k)) for k, n in self._held.items()),
                                  key=lambda t: -t[0])[:self.top]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    with dryrun.fake_group(dryrun.WORLD):
        mesh = make_production_mesh(multi_pod=False)
        _, fn, cell_args, _ = dryrun.build_cell(args.arch, dryrun._shape(args.shape), mesh)
        with PeakTrace(dryrun._tensors(cell_args), args.top) as trace:
            fn(*cell_args)
    print(f"{args.arch} {args.shape} pod16x16: peak temp {trace.peak / 1e9:.3f} GB; "
          f"the {len(trace.at_peak)} largest storages live at it:")
    for n, (shape, dtype, where) in trace.at_peak:
        print(f"  {n / 1e9:8.3f} GB {dtype}{shape}  {where}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
