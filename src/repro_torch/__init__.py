"""StreamServe on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro`` that imports ``torch`` and numpy only.
Its layout mirrors ``repro`` module for module; the two attention kernels on
the serving main path are hand-written CUDA C++ under ``kernels/csrc/``.
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``.
"""
