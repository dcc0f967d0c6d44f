"""PyTorch/CUDA port of the ``repro`` JAX package, for one NVIDIA H100.

The module layout and public names follow ``repro`` so that each ported
function sits beside its reference.  The port imports ``torch`` and numpy,
never ``jax`` and nothing from ``repro``.
"""
