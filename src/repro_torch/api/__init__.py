"""``repro_torch.api`` — the vector-search facade of the port.

    from repro_torch.api import open_index
    sess = open_index(X, method="PDScanning+")        # on the CUDA card
    res = sess.search(Q, k=10)
    print(res.ids, res.qps, res.stats.extra["dims_read_mean"])
    sess.save("idx.bin")                              # snapshot + delta WAL
    svc = sess.serve(slots=16, k=10)                  # the serving front
"""
from repro_torch.api.persistence import DeltaWAL, IndexLoadError  # noqa: F401
from repro_torch.api.session import (INDEX_KINDS, METHODS,  # noqa: F401
                                     SearchSession, open_index)
from repro_torch.api.types import (STAT_EXTRA_KEYS,  # noqa: F401
                                   SchedulePolicy, SearchResult)
from repro_torch.core.engine import QueryBatch, ScanStats  # noqa: F401
from repro_torch.core.guardrails import (BREAKER_STATES,  # noqa: F401
                                         Guardrail, GuardrailConfig)
