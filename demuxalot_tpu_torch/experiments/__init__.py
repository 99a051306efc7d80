"""The port's counterparts of the JAX package's kernel experiments under ``benchmarks/``.

- :mod:`.inkernel_gather`: ``benchmarks/inkernel_gather_kernels.py`` (the
  variant-banded E-step and the barcode-banded M-step) and the A/B of
  ``benchmarks/exp_inkernel_gather_estep.py``;
- :mod:`.kernel_gather`: ``benchmarks/exp_kernel_gather.py`` (the row-gather
  canary and the gather-rate bench);
- :mod:`.folded_estep`, :mod:`.split_estep`, :mod:`.group_estep`:
  ``benchmarks/exp_estep.py``, ``exp_split.py`` and ``exp_group.py`` (the
  E-step variants: folded, split-word bf16 on the tensor cores, group-G),
  and :mod:`.estep_variants`, their shared workload and A/B against the
  mainline E-step;
- :mod:`.dma_pattern`: ``benchmarks/exp_dma_pattern.py`` (strided column
  slices against contiguous rows, streamed);
- :mod:`.gather_forms`: ``benchmarks/exp_gather_forms.py`` (the gather
  forms and the gather from a table held on chip);
- :mod:`.gather_operand`: ``benchmarks/exp_gather_operand.py`` (a gather
  beside the E-step and a tiny kernel).

Each kernel is hand-written CUDA (``csrc/likelihood.cu``'s banded
instantiation, ``csrc/banded.cu``, ``csrc/gather.cu``, ``csrc/folded.cu``,
``csrc/split.cu``, ``csrc/group.cu``, ``csrc/stream.cu``,
``csrc/forms.cu``, ``csrc/tiny.cu``) beside a plain PyTorch version; the
wrappers launch the kernel for CUDA tensors and run the plain version for
CPU tensors. No package path calls them. Run them with ``python -m
demuxalot_tpu_torch.experiments.<module> [--device cpu]``.
"""
