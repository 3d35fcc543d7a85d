"""Hand-written Hopper kernels of the port (CUDA C++ in ``../csrc``), each
with its plain PyTorch version, which a CPU tensor takes."""
from . import agu, datapath, ops, ref  # noqa: F401
