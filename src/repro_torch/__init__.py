"""PyTorch/CUDA port of the butterfly split-serving system.

A package of its own beside the JAX reference (``repro``): it imports
``torch``, ``numpy`` and the standard library, never ``jax`` and nothing of
``repro``.  Module names mirror the JAX package.  Every entry point takes
an explicit ``device`` that defaults to ``"cuda"`` and raises when CUDA is
absent unless the caller asks for ``"cpu"``; on a CUDA tensor the butterfly
wrappers launch the hand-written Hopper kernels in ``csrc/``.
"""
