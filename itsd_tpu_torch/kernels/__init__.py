"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``groupnorm`` (GroupNorm+swish) and ``attention`` (flash attention
forward and its dq and dk/dv backward). ``_build`` compiles ``csrc/*.cu`` at
first use."""
