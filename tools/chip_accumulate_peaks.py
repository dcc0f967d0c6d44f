#!/usr/bin/env python3
"""The train step's peak memory with each bf16 gradient widened to an fp32
copy before it is added into its fp32 accumulator, and as the port adds it
(as it is), on one CUDA card.

    python3 tools/chip_accumulate_peaks.py

Runs ``chip_smoke.py``'s ``_train_run`` (1 warm-up and 3 timed steps) on
phase 12's config (Yi-6B's widths, 8 of 32 layers) and on phases 34-35's
models whole, each twice in the order widened copy, as it is: the first arm
swaps ``runtime/steps.py``'s ``_accumulate`` for the cast version kept
below.  Both arms compute the same sums bit for bit
(``tests/test_torch_train.py``), so the losses must agree.  Prints each
run's step ms and peak memory on a line starting ``[accumulate]``, then the
card's name and power limit.
"""
import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from repro_torch.runtime import steps  # noqa: E402  (chip_smoke puts src/ on the path)


def _accumulate_cast(acc, grads, dtype):
    """``steps._accumulate`` before it added a widening gradient as it is:
    each gradient cast to ``dtype`` (an fp32 copy of a bf16 one) first."""
    if acc is None:
        return [g.to(dtype, copy=True) for g in grads]
    for a, g in zip(acc, grads):
        a.add_(g.to(dtype))
    return acc


def main():
    device, smi = cs.phase_probe()
    cs.phase_build()
    port = steps._accumulate
    runs = [("phase 12", cs._yi_train_cfg())] + [
        (key, cs.get_config(arch)) for key, arch in {**cs.TRAIN_SSM, **cs.TRAIN_WHOLE}.items()]
    for key, cfg in runs:
        losses = {}
        for arm, fn in (("widened copy", _accumulate_cast), ("as it is", port)):
            steps._accumulate = fn
            try:
                r = cs._train_run("accumulate", cfg, device, smi, f"{key}, {arm}")
            finally:
                steps._accumulate = port
            losses[arm] = r["losses"]
            print(f"[accumulate] {key} ({cfg.name}) {arm}: step_ms={r['step_ms']:.1f} "
                  f"peak_mem_gb={r['peak_mem_gb']:.3f}", flush=True)
            torch.cuda.empty_cache()
        if losses["widened copy"] != losses["as it is"]:
            raise SystemExit(f"[accumulate] {key}: the arms' losses differ: {losses}")
    print(smi)


if __name__ == "__main__":
    main()
