"""repro_torch — the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

Mirrors ``repro``'s layout: ``configs``, ``models``, ``kernels`` (hand-written
CUDA/Triton kernels beside their plain PyTorch versions), ``core`` (the PAS
routing record), ``sched``, ``serve`` and ``launch``. It imports torch and
numpy only.
"""
