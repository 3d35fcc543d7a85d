"""repro_torch — the PyTorch / CUDA port of the XDMA reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
paths (``repro/core/layouts.py`` has its twin at
``repro_torch/core/layouts.py``) and never imports it or JAX.  Kernels are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), built at first use.
"""
