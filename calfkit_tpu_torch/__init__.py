"""calfkit-tpu's local inference backend on PyTorch and CUDA.

A second package beside ``calfkit_tpu``: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``calfkit_tpu``.  Its entry points run on a
CUDA device unless the caller passes ``device="cpu"``; the attention
kernels are hand-written CUDA C++ (``csrc/``) built at first use.
"""
