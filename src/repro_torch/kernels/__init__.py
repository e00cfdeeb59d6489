"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain versions.

Each kernel directory mirrors the JAX package's: ``ref.py`` holds the plain
PyTorch version, ``ops.py`` the wrapper that launches the CUDA kernel on a
CUDA tensor (and runs the plain version on a CPU tensor). The CUDA sources
live in ``csrc/`` and are built at first use by :mod:`._build`.
"""
