"""Device resolution: entry points run on the card unless the CPU is asked for."""
from __future__ import annotations

import torch

# the hand-written kernels are compiled for sm_90a, which runs on Hopper only
REQUIRED_CAPABILITY = (9, 0)


def resolve_device(name: str = "cuda") -> torch.device:
    """Return the device ``name`` names, refusing to fall back to the CPU.

    ``"cpu"`` is returned as asked.  Any CUDA device requires a visible card
    of capability ``REQUIRED_CAPABILITY``; otherwise this raises.
    """
    device = torch.device(name)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    cap = torch.cuda.get_device_capability(device)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(device)} has capability {cap}; "
            f"the kernels are built for sm_90a and need {REQUIRED_CAPABILITY}")
    return device


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
