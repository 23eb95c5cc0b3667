"""Kernels of the port: hand-written CUDA (``csrc/``) and Triton kernels,
each beside its plain PyTorch version (``ref``), reached through ``ops``."""
