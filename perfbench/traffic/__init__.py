"""Traffic: one data file a mix (``<name>.json``) and one driver a kind
(``<kind>.py``), found by name.  A driver has ``warm(run)``,
``window(run, seconds)`` and ``traced(run)``."""
