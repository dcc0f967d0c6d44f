"""Closed-loop autotuning + paper-§V evaluation subsystem (DESIGN.md §9),
the port of the JAX package's ``repro/eval``.

* ``eval/autorun.py`` — :class:`AutoTunedRun`: predict a partitioning (or
  fall back to the ds-array default square heuristic when the estimator
  abstains), execute on the task-graph runtime with the data on its
  device, persist the measured record, and refit the estimator
  incrementally — every run makes the next prediction better.
* ``eval/harness.py`` — paper-§V-style evaluation: exact-hit rate and
  exponent distance of predictions vs. grid-search argmin labels, modeled
  speedup of predicted vs. default partitioning, and leave-one-out
  generalization splits over algorithms and environments; and the kernel
  tile tuner's evaluation (``evaluate_kernels``).
"""
from repro_torch.eval.autorun import AutoTunedRun, default_partitioning
from repro_torch.eval.harness import evaluate, write_report

__all__ = ["AutoTunedRun", "default_partitioning", "evaluate",
           "write_report"]
