"""``repro_torch.utils`` — the program's spans and counters (``trace``)."""
