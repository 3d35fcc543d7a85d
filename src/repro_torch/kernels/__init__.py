"""Hand-written Hopper kernels of the port (CUDA C++ in ``../csrc``), each
with its plain PyTorch version, which a CPU tensor takes."""
from . import (agu, datapath, flash_attention, fused_rmsnorm_relayout,  # noqa: F401
               ops, quant, ref)
