"""Named spans inside the program, recorded by ``torch.profiler``.

``span(name, arg)`` marks where the program does one piece of work: a train
step and its microbatches, a layer and its recomputation, the head, a
decode step, an attention, MoE or SSD block, a serve call's phases.  Off,
the default, a span is one check of a module flag and makes no profiler
object.  After ``enable()`` it opens ``torch.profiler.record_function(name)``
with ``arg`` (the step, microbatch, leaf or layer number) as its argument:
a profiler that runs records the span on its own clock, nested with the
aten ops and kernel launches made inside it, and without one nothing is
recorded.  There is no other output::

    trace.enable()
    with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
        step(...)
    trace.disable()

On the card, autograd runs a backward on its own device thread: the
gradient hooks (``train.accumulate``) and remat's re-run of a layer
(``model.recompute``) open their spans there, and the kernels the backward
launches outside them run under the caller's ``train.backward``, open on
the caller's thread.  A reader of the trace attributes a launch by its
thread (``tools/profile_torch_serve.py::span_paths``).

``NAMES`` holds every name the program passes to ``span``.
"""
from __future__ import annotations

import contextlib

import torch

NAMES = frozenset({
    "train.step", "train.microbatch", "train.forward", "train.backward",
    "train.accumulate", "train.optimizer",
    "model.layer", "model.recompute", "model.head",
    "attention.forward", "attention.decode", "moe.apply", "ssd.forward", "ssd.decode",
    "decode.step", "serve.prefill", "serve.grow_cache", "serve.sample",
})

_on = False
_OFF = contextlib.nullcontext()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str, arg=None):
    """A context manager: ``record_function(name, str(arg))`` when enabled,
    else a shared no-op."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name, None if arg is None else str(arg))
