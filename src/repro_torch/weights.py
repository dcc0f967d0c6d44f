"""Model weights: carried across from the JAX package, or drawn on the device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import ParamSpec, init_param_tree
from repro_torch.runtime.optim import opt_state_specs


def _to_tensor(arr: np.ndarray, spec: ParamSpec, device) -> torch.Tensor:
    arr = np.array(arr, order="C")           # a writable copy torch may own
    if arr.dtype.name == "bfloat16":          # numpy has no bfloat16 of its own
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=spec.torch_dtype)


def _convert(spec, leaf, path: str, device):
    if isinstance(spec, ParamSpec):
        arr = np.asarray(leaf)
        if arr.shape != tuple(spec.shape):
            raise ValueError(f"{path}: shape {arr.shape}, expected {spec.shape}")
        return _to_tensor(arr, spec, device)
    if isinstance(spec, dict):
        if not isinstance(leaf, dict) or set(leaf) != set(spec):
            got = sorted(leaf) if isinstance(leaf, dict) else type(leaf).__name__
            raise ValueError(f"{path}: keys {got}, expected {sorted(spec)}")
        return {k: _convert(spec[k], leaf[k], f"{path}/{k}", device) for k in spec}
    if not isinstance(leaf, (tuple, list)) or len(leaf) != len(spec):
        raise ValueError(f"{path}: expected a sequence of {len(spec)}")
    return tuple(_convert(s, x, f"{path}[{i}]", device)
                 for i, (s, x) in enumerate(zip(spec, leaf)))


def params_from_jax(cfg: ModelConfig, tree, device="cpu"):
    """The JAX package's parameter tree, with numpy leaves, as the port's.

    ``tree`` is nested dicts and tuples exactly as the JAX package's
    ``init_param_tree(param_specs(cfg), key)`` returns them, each leaf
    converted with ``np.asarray``.  Structure and shapes are checked against
    the port's ``param_specs(cfg)``.
    """
    return _convert(tfm.param_specs(cfg), tree, "params", torch.device(device))


def opt_state_from_jax(cfg: ModelConfig, tree, device="cpu"):
    """The JAX package's optimizer state (``opt_state_specs`` materialized,
    numpy leaves) as the port's, checked against the port's
    ``opt_state_specs(cfg, param_specs(cfg))`` for structure and shapes."""
    specs = opt_state_specs(cfg, tfm.param_specs(cfg))
    return _convert(specs, tree, "opt_state", torch.device(device))


def init_params(cfg: ModelConfig, generator: torch.Generator, device):
    """Random weights by the JAX package's init rule, drawn on ``device``."""
    return init_param_tree(tfm.param_specs(cfg), generator, torch.device(device))
