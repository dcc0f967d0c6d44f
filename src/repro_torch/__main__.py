"""``python -m repro_torch`` — dispatch lives in ``repro_torch/launch/__main__.py``."""
from repro_torch.launch.__main__ import main

if __name__ == "__main__":
    raise SystemExit(main())
