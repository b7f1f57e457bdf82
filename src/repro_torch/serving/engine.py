"""Batched serving engine: continuous batching over the decode step.

Counterpart of the reference package's ``serving/engine.py``.  The
device-side step is ``api.decode_step``, called eagerly; this host loop
packs requests into fixed decode slots, admits new requests as slots
free up, and tracks PER-SLOT sequence lengths — decode_step accepts a
vector ``cur_len`` so heterogeneous requests coexist in one batch (the
continuous-batching pattern, minus paged KV; contiguous per-slot cache).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new: int = 32
    out: list = field(default_factory=list)
    cursor: int = 0              # how many prompt tokens have been fed


class ServingEngine:
    def __init__(self, api, *, slots: int = 8, max_len: int = 512):
        self.api = api
        self.slots = slots
        self.max_len = max_len
        self.decode = api.decode_step

    def run(self, params, requests: list, *, max_steps: int = 100_000):
        """Serve ``requests`` to completion; returns {rid: generated ids}.

        Prompts are fed token-at-a-time through the same decode path;
        slots with exhausted prompts sample greedily over the real vocab
        (the logits are copied to the host each step).  Idle slots step on
        harmlessly: a later request overwrites a position before it reads
        it.  A prompt of ``max_len`` tokens
        or more runs past the cache, as in the reference's engine, whose
        out-of-range writes are dropped: the step is asked for the same
        (``past_cache="drop"``).  A slot's cache is not reset when it
        takes a request, as in the reference's: attention reads only up
        to ``cur_len``, but an SSM state runs on (ROADMAP C10).
        """
        cfg = self.api.cfg
        queue = deque(requests)      # popleft admission is O(1), not O(n)
        cache = self.api.init_cache(self.slots, self.max_len)
        lens = np.zeros(self.slots, np.int64)          # tokens already in cache
        cur_tok = np.zeros(self.slots, np.int64)
        slot_req: list = [None] * self.slots
        results: dict = {}
        for _ in range(max_steps):
            for s in range(self.slots):
                if slot_req[s] is None and queue:
                    req = queue.popleft()
                    slot_req[s] = req
                    lens[s] = 0
                    req.cursor = 0
                    cur_tok[s] = int(req.prompt[0])
            if all(r is None for r in slot_req) and not queue:
                break
            toks = cur_tok.astype(np.int32)
            step_len = np.maximum(lens + 1, 1).astype(np.int32)
            logits, cache = self.decode(params, cache, toks, step_len,
                                        past_cache="drop")
            logits = np.asarray(logits.cpu())
            for s in range(self.slots):
                req = slot_req[s]
                if req is None:
                    continue
                lens[s] += 1
                req.cursor += 1
                if req.cursor < len(req.prompt):
                    cur_tok[s] = int(req.prompt[req.cursor])
                else:
                    nxt = int(np.argmax(logits[s, : cfg.vocab]))
                    req.out.append(nxt)
                    cur_tok[s] = nxt
                    if len(req.out) >= req.max_new or lens[s] >= self.max_len - 1:
                        results[req.rid] = list(req.out)
                        slot_req[s] = None
        return results
