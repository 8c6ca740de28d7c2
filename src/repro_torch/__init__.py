"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

A package of its own beside the JAX package: it imports ``torch`` and
never ``jax`` or ``repro``. Module names follow the JAX package's, so each
part's counterpart is found by name. Every TPU kernel on the ported path
is a kernel written by hand for Hopper (``kernels/csrc``), each beside its
plain PyTorch version (``kernels/ref.py``).
"""
