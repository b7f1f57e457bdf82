"""One reader a metric: ``<metric>.py`` with ``read(run)``, which returns
the metric's value or ``None`` when the run holds nothing to read."""
