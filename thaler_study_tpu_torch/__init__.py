"""PyTorch/CUDA port of ``thaler_study_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; this package imports
nothing of it and nothing of JAX. Module names mirror the reference's so
that each counterpart is easy to find. Plain torch versions of every kernel
serve CPU tensors (the CPU tests); CUDA tensors go to the hand-written
kernels under ``csrc/``, which are built with ``nvcc`` at first use.
"""
