"""``repro_torch.api`` — the vector-search facade of the port.

    from repro_torch.api import open_index
    sess = open_index(X, method="PDScanning+")        # on the CUDA card
    res = sess.search(Q, k=10)
    print(res.ids, res.qps, res.stats.extra["dims_read_mean"])
"""
from repro_torch.api.session import (INDEX_KINDS, METHODS,  # noqa: F401
                                     SearchSession, open_index)
from repro_torch.api.types import (STAT_EXTRA_KEYS,  # noqa: F401
                                   SchedulePolicy, SearchResult)
from repro_torch.core.engine import ScanStats  # noqa: F401
