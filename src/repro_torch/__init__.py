"""PyTorch/CUDA port of the Cuckoo-GPU filter library.

Mirrors the layout of the JAX package (``core/``, ``kernels/``, ``amq/``,
``filters/``, ``data/``) so each module has a counterpart. The hot
operations of the ``cuckoo`` and ``bloom`` backends and the k-mer pack run
on hand-written CUDA kernels for Hopper (``kernels/csrc/``); every kernel
has a plain PyTorch version beside it that runs when the tensors live on
the CPU.

    from repro_torch import amq
    h = amq.make("cuckoo", capacity=1_000_000)          # on the GPU
    h = amq.make("cuckoo", capacity=1_000, device="cpu")  # plain versions

This package imports ``torch`` and never ``jax``.
"""
