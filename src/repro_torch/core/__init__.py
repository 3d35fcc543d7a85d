"""repro_torch.core — XDMA: layout-flexible data movement as a PyTorch module.

Re-exports the names of ``repro.core``: the layout IR, the plugins, the
descriptor (with the page geometry and the canonical reduce), the cost-model
autotuner, the engine, the remote engine on ``torch.distributed``, the
plugin compiler, the ``xdma.transfer`` API and the Fig. 4 software
baselines.
"""
from .layouts import (  # noqa: F401
    Layout, MN, NM, MNP64, MNM8N128, MNM16N128, MNM32N128, MNM8N8,
    NMM8N128, KV4M8N128, AUTO,
    affine_pattern, AffinePattern, PatternPair, relayout_pair,
    layout_for_dtype, tiled_layout, by_name,
)
from .plugins import (  # noqa: F401
    Plugin, Identity, Transpose, Cast, Scale, BiasAdd,
    RMSNormPlugin, Quantize, Dequantize, QTensor, apply_chain,
    GatherScatter, Compress, Decompress, CTensor, ReduceStage,
    register_plugin, plugin_by_name, registered_plugins,
)
from .descriptor import (  # noqa: F401
    Endpoint, XDMADescriptor, describe, from_spec, reduce_descriptor,
    page_layout, page_descriptor,
)
from . import autotune  # noqa: F401  (best_layout, resolve_descriptor, ...)
from .autotune import best_layout, resolve_descriptor, autotune_stats  # noqa: F401
from .engine import xdma_copy, xdma_copy_pallas, reader, writer  # noqa: F401
from .remote import (  # noqa: F401
    xdma_ppermute, xdma_all_to_all, xdma_psum, compressed_psum,
    compressed_psum_with_feedback,
)
from .api import (  # noqa: F401
    XDMAQueue, transfer, cache_stats, clear_cache,
    cache_capacity, set_cache_capacity, reset_process_state,
)
from . import api as xdma  # noqa: F401  (usage: from repro_torch.core import xdma)
from . import baselines  # noqa: F401
from . import plugin_compiler  # noqa: F401  (cfg_stats, compile_local, ...)
