"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper.

Laid out file for file like ``repro``; each module names its reference
twin.  Imports ``torch`` and numpy, never ``jax`` or ``repro``.
"""
