"""PyTorch + CUDA port of the repro accelerator stack, for an NVIDIA H100.

The layout mirrors ``repro/``: ``configs``, ``models``, ``kernels`` (hand-written
CUDA under ``csrc/``), ``serving`` and ``launch``. The package imports torch,
numpy and the standard library only. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; on a CPU tensor every kernel wrapper takes its
plain PyTorch version instead (see ``kernels/ops.py``).
"""
