"""The port's counterparts of the JAX package's in-kernel-gather experiments.

- :mod:`.inkernel_gather`: ``benchmarks/inkernel_gather_kernels.py`` (the
  variant-banded E-step and the barcode-banded M-step) and the A/B of
  ``benchmarks/exp_inkernel_gather_estep.py``;
- :mod:`.kernel_gather`: ``benchmarks/exp_kernel_gather.py`` (the row-gather
  canary and the gather-rate bench).

Each kernel is hand-written CUDA (``csrc/likelihood.cu``'s banded
instantiation, ``csrc/banded.cu``, ``csrc/gather.cu``) beside a plain
PyTorch version; the wrappers launch the kernel for CUDA tensors and run the
plain version for CPU tensors. No package path calls them. Run them with
``python -m demuxalot_tpu_torch.experiments.<module> [--device cpu]``.
"""
