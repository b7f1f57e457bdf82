"""Helpers that check a sequence-sharded KV cache (``models.placement``'s
``SeqShard``) from outside the serving path.

* ``copy_prefix`` grows a prefill's cache into a longer one, each placed
  as it is.  A sequence-sharded source is gathered whole first, which no
  serving path may do (the placement module never gathers a cache), so
  the helper lives here, beside the checks that need it.
* ``attention_outputs`` reads each decode attention's f32 output before
  its bf16 cast, on a whole cache and on a split one, and can plant a
  fault in the split one's merge:

      with attention_outputs() as one:           # (1, 1)
          api.decode_step(...)
      with attention_outputs() as split:         # (2, 1): the merged output
          api.decode_step(...)
      with attention_outputs(zero_terms=rank == 1) as lost:
          api.decode_step(...)                   # rank 1's terms dropped

  Each list holds one (B, Hkv, G, hd) f32 tensor on the host a
  ``decode_attention`` (GQA) call, in call order: a layer each step.
  MLA's latent decode is not read.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.models import layers as L
from repro_torch.models import placement as P


def copy_prefix(dst, src, *, seq_axis: int = 2):
    """``src``'s positions (a placed or plain cache leaf) into the first
    positions of ``dst``, each placed as it is.  A sequence-sharded
    ``src`` is gathered whole first and a sequence-sharded ``dst`` takes
    its range of them: between two lengths the ranks hold different
    positions, so this is a redistribution, not a local copy."""
    whole = P.full(src) if P.seq_shard(src, seq_axis) else P.local(src)
    sh = P.seq_shard(dst, seq_axis)
    start = sh.start if sh else 0
    out = P.local(dst)
    n = min(out.shape[seq_axis], whole.shape[seq_axis] - start)
    if n > 0:
        out.narrow(seq_axis, 0, n).copy_(whole.narrow(seq_axis, start, n))


@contextlib.contextmanager
def attention_outputs(*, zero_terms: bool = False):
    """Yields a list that receives each decode attention's f32 output, on
    the host, in call order: on a sequence-sharded cache the merged one
    (``placement.merge_softmax``'s result), on a whole cache
    ``layers.decode_attention``'s mix before its cast.  With
    ``zero_terms``, this rank adds zeros to the merge's sums (its share
    of the softmax mass and of the weighted values), as if its positions
    were lost: a planted fault that a check of the outputs must catch."""
    mix, merge, rec = L.grouped_mix, P.merge_softmax, []
    depth = [0]

    def read_mix(p, v):
        out = mix(p, v)
        if not depth[0]:
            rec.append(out.detach().float().cpu())
        return out

    def read_merge(s, valid, mix_fn, reduce):
        def faulty(x, op):
            return reduce(torch.zeros_like(x) if op == "sum" else x, op)
        depth[0] += 1
        try:
            out = merge(s, valid, mix_fn, faulty if zero_terms else reduce)
        finally:
            depth[0] -= 1
        rec.append(out.detach().float().cpu())
        return out

    L.grouped_mix, P.merge_softmax = read_mix, read_merge
    try:
        yield rec
    finally:
        L.grouped_mix, P.merge_softmax = mix, merge
