"""notorch-tpu on PyTorch and CUDA: the port of :mod:`notorch_tpu` to an
NVIDIA Hopper GPU.

The module tree mirrors ``notorch_tpu`` so that every module has a
counterpart of the same name. This package never imports ``jax`` or
``notorch_tpu``; it keeps its own copies of the numpy-only featurization
modules. Kernels are hand-written CUDA C++ under ``csrc/``, built with
``nvcc`` at first use (:mod:`notorch_tpu_torch.kernels`).
"""
