"""itsd_tpu_torch: the PyTorch/CUDA port of itsd_tpu, for NVIDIA Hopper.

It mirrors the JAX package's module names (``core``, ``models``,
``kernels``, ``train``, ``data``, ``utils``, ``cli``, ``parallel``) and
imports nothing of it. The Pallas
kernels on its path are hand-written CUDA in ``csrc/``, built at first use
by ``kernels/_build.py``; each sits beside a plain PyTorch version, which
runs only for tensors on the CPU.
"""
