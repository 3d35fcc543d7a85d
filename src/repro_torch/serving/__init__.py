"""repro_torch.serving — the serving engine and the KV-cache movement plane
(PyTorch port).

:class:`~repro_torch.serving.engine.ServingEngine` (batched prefill + greedy
decode, its cache through the plane every step), the transfers of
:mod:`~repro_torch.serving.transfer` (Prefill store, Load, cross-stage
tunnel, multicast fan-outs) and the paged KV pool of
:mod:`~repro_torch.serving.paged`.
"""
from .engine import ServingEngine, make_serve_step  # noqa: F401
from .transfer import (  # noqa: F401
    kv_prefill_store, kv_load_transposed, cross_stage_transfer,
    replica_weight_broadcast, prefix_cache_fanout,
)
from .paged import (  # noqa: F401
    Page, PagedKVPool, default_serving_topology, paginate, depaginate,
    pages_for_rows, DEFAULT_PAGE_ROWS,
)
