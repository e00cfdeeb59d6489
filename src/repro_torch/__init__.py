"""repro_torch — the ABO solver of "Super-speeds with Zero-RAM" in PyTorch.

The port of :mod:`repro` (JAX) to PyTorch and hand-written CUDA kernels
for an NVIDIA Hopper card. Each module sits at the same relative path as
the JAX module it is held against. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; with no card and no device they raise.
"""
__version__ = "0.1.0"
