"""``repro_torch.serving`` — the serving fronts of the port.

``SearchService`` packs single queries into fixed-shape batches over one
``SearchSession`` (continuous batching, bounded admission, per-request
deadlines, the LSM-style delta write path; DESIGN.md §6-7).
``ReplicatedService`` stacks the fault-tolerant replica tier on top —
retry/backoff, hedged dispatch, breaker-gated routing and shard-loss
graceful degradation (DESIGN.md §10); ``open_replicated`` builds one from
a corpus.  ``dco_decode_attention`` screens a decode step's cached keys
on their leading rotated dims before exact attention over the top-C
(``exact_decode_attention`` is its oracle).  ``ServingEngine`` is the
continuous-batching loop for LM decode over ``repro_torch.models``.
"""
from repro_torch.serving.dco_attention import (  # noqa: F401
    dco_decode_attention, exact_decode_attention, fit_key_rotation)
from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
from repro_torch.serving.replica import (REPLICA_MODES,  # noqa: F401
                                         ReplicaDispatchError, ReplicaPolicy,
                                         ReplicatedService, open_replicated)
from repro_torch.serving.search_service import (SearchRequest,  # noqa: F401
                                                SearchService)
