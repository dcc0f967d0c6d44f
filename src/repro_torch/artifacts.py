"""Artifacts-directory resolution for the port's launchers.

The precedence is the JAX package's: an explicit path argument > the
``REPRO_ARTIFACTS`` environment variable > the checkout's ``artifacts/``.
The port writes under ``<artifacts>/torch/`` so that its store and
reports never overwrite the reference's.
"""
from __future__ import annotations

import os
from pathlib import Path

_DEFAULT = Path(__file__).resolve().parents[2] / "artifacts"


def artifacts_dir(override=None) -> Path:
    """Resolve the port's artifacts directory (not created here)."""
    if override is not None:
        return Path(override)
    env = os.environ.get("REPRO_ARTIFACTS")
    return (Path(env) if env else _DEFAULT) / "torch"
