"""``repro_torch.utils`` — host wall-clock helpers (``timing``)."""
from repro_torch.utils.timing import Timer, bench_call  # noqa: F401
