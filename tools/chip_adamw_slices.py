#!/usr/bin/env python3
"""AdamW's update whole-leaf against in slices, on one CUDA card.

    python3 tools/chip_adamw_slices.py

Trains musicgen-large whole and h2o-danube-3-4b whole through
``chip_smoke.py``'s ``_train_run`` (1 warm-up and 3 timed steps each), four
runs a model in the order whole-leaf, sliced, sliced, whole-leaf, so that a
drift of the card or the host shows in both arms alike.  Whole-leaf sets
``runtime/optim.py``'s ``ADAMW_SLICE`` past any leaf's size; sliced keeps
its value.  Prints each run's step ms and peak memory on a line starting
``[ab]``, then the card's name and power limit.
"""
import importlib.util
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from repro_torch.runtime import optim  # noqa: E402  (chip_smoke puts src/ on the path)


def main():
    device, smi = cs.phase_probe()
    cs.phase_build()
    sliced = optim.ADAMW_SLICE
    for arch in ("musicgen-large", "h2o-danube-3-4b"):
        for on in (False, True, True, False):
            optim.ADAMW_SLICE = sliced if on else 1 << 62
            arm = "sliced" if on else "whole-leaf"
            cfg = cs.get_config(arch)
            r = cs._train_run("ab", cfg, device, smi, f"{arch} whole, AdamW {arm}")
            print(f"[ab] {arch} {arm} step_ms={r['step_ms']:.1f} "
                  f"peak_mem_gb={r['peak_mem_gb']:.3f}", flush=True)
            torch.cuda.empty_cache()
    optim.ADAMW_SLICE = sliced
    print(smi)


if __name__ == "__main__":
    main()
