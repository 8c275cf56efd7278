"""Hand-written CUDA kernels, one module each, with their plain twins.

Every module exposes one dispatching wrapper: a CUDA tensor launches the
kernel (or the wrapper raises), a CPU tensor takes the plain PyTorch
version in the same module. Kernels are built from ``../csrc`` at first
use by :mod:`magellanmapper_torch.kernels._build`.
"""
