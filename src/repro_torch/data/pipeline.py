"""Deterministic, resumable token data pipeline.

Counterpart of the reference package's ``data/pipeline.py`` (numpy and
threading only, so its batches are the reference's numbers).  Batches are
a pure function of (seed, step), so a restarted job consumes the
identical stream with no cursor file.  A host-side prefetch thread keeps
``depth`` batches in flight ahead of the train loop.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


def make_batch_fn(cfg, shape, *, seed: int = 0):
    """Returns batch_fn(step) -> batch dict for the arch family; stateless."""
    B, S = shape.global_batch, shape.seq_len

    def batch_fn(step: int):
        rng = np.random.default_rng((seed * 1_000_003 + step) % (2 ** 63))
        out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.family == "encdec":
            out["src_embeds"] = rng.standard_normal(
                (B, min(S, 1024), cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm" and cfg.prefix_len:
            out["patches"] = rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        return out

    return batch_fn


class TokenPipeline:
    """Prefetching wrapper: ``for step, batch in pipeline.iter(start, stop)``."""

    def __init__(self, batch_fn, *, depth: int = 2):
        self.batch_fn = batch_fn
        self.depth = depth

    def iter(self, start: int, stop: int):
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop_flag = threading.Event()

        def producer():
            for step in range(start, stop):
                if stop_flag.is_set():
                    return
                q.put((step, self.batch_fn(step)))
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop_flag.set()
