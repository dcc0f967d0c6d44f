"""Evaluation of the kernel tile tuner (the kernel part of the JAX
package's ``eval/harness.py``)."""
