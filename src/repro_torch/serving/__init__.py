"""repro_torch.serving — the serving engines and the KV-cache movement plane
(PyTorch port).

:class:`~repro_torch.serving.engine.ServingEngine` (batched prefill + greedy
decode, its cache through the plane every step), the transfers of
:mod:`~repro_torch.serving.transfer` (Prefill store, Load, cross-stage
tunnel, multicast fan-outs), the paged KV pool of
:mod:`~repro_torch.serving.paged`, the request streams of
:mod:`~repro_torch.serving.requests` and the continuous-batching and
static-gang engines of :mod:`~repro_torch.serving.continuous`.
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
from .requests import Request, poisson_stream, trace_stream, uniform_stream  # noqa: F401
from .continuous import ContinuousBatchingEngine, StaticBatchEngine, ServeReport  # noqa: F401
