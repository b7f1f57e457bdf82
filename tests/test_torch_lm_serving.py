"""The port's continuous-batching LM engine (repro_torch.serving.ServingEngine)
against the reference package's.

1. A stub model in each framework whose logits are a fixed integer
   function of (token, cur_len): the two engines give exactly the same
   results (admission with more requests than slots, prompts of mixed
   lengths, the ``max_len`` stop, idle slots).
2. The real ``smoke_config("qwen3-4b")`` decoder on the reference's
   weights: each request's greedy ids equal the reference's up to its
   first near-tie (a step where the reference's top-2 margin is within
   the model tests' tolerance), and teacher-forced on the reference's ids
   the port's logits stay within that tolerance at every step, past a
   near-tie too.
3. ``python -m repro_torch.launch.serve --device cpu`` serves every
   request.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import build_model as ref_build_model
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serving import Request, ServingEngine

TOL = 4e-2          # tests/test_torch_models.py's, relative to max |logits|
V, VOCAB = 41, 37   # the stub's padded and real vocab


def _jax_stub():
    def decode_step(params, cache, token, cur_len):
        t = token.astype(jnp.int32)[:, None]
        c = jnp.broadcast_to(cur_len, token.shape).astype(jnp.int32)[:, None]
        v = jnp.arange(V, dtype=jnp.int32)[None, :]
        return ((t * 7 + c * 13 + v * 5 + (t * v) % 11) % V).astype(
            jnp.float32), cache + 1
    return SimpleNamespace(cfg=SimpleNamespace(vocab=VOCAB),
                           decode_step=decode_step,
                           init_cache=lambda b, n: jnp.zeros((b,), jnp.int32))


def _torch_stub():
    def decode_step(params, cache, token, cur_len):
        t = torch.as_tensor(token).long()[:, None]
        c = torch.as_tensor(cur_len).long().expand(t.shape[0])[:, None]
        v = torch.arange(V)[None, :]
        return ((t * 7 + c * 13 + v * 5 + (t * v) % 11) % V).float(), cache + 1
    return SimpleNamespace(cfg=SimpleNamespace(vocab=VOCAB),
                           decode_step=decode_step,
                           init_cache=lambda b, n: torch.zeros(b, dtype=torch.int32))


def _prompts(n, lo, hi, seed, vocab=VOCAB):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("n_req,slots,max_len,max_new,lo,hi", [
    (9, 3, 64, 5, 1, 8),        # more requests than slots, mixed prompts
    (5, 2, 9, 20, 3, 7),        # every request stops at max_len
    (2, 4, 32, 6, 1, 3),        # idle slots
    (7, 4, 12, 6, 2, 9),        # some stop at max_new, some at max_len
])
def test_engine_gives_the_reference_results_on_a_stub(n_req, slots, max_len,
                                                      max_new, lo, hi):
    prompts = _prompts(n_req, lo, hi, seed=n_req * 100 + slots)
    ref_reqs = [RefRequest(i, p, max_new) for i, p in enumerate(prompts)]
    reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    want = RefEngine(_jax_stub(), slots=slots, max_len=max_len).run(
        None, ref_reqs)
    got = ServingEngine(_torch_stub(), slots=slots, max_len=max_len).run(
        None, reqs)
    assert got == want and len(got) == n_req
    for r, q in zip(ref_reqs, reqs):
        assert q.out == r.out and q.cursor == r.cursor
        # the reference's stopping rule: max_new, or the cache is full
        assert len(q.out) == max_new or len(q.prompt) + len(q.out) >= max_len - 1


@pytest.fixture(scope="module")
def smoke_pair():
    cfg = smoke_config("qwen3-4b")
    rapi = ref_build_model(ref_smoke_config("qwen3-4b"), remat="none")
    rparams = rapi.init(jax.random.PRNGKey(0))
    api = build_model(cfg, device="cpu")
    return cfg, rapi, rparams, api, params_from_reference(cfg, rparams,
                                                         device="cpu")


def _teacher_forced(decode, init_cache, seq):
    """Logits (len(seq), Vp) of one sequence fed token by token."""
    cache, out = init_cache(1, len(seq) + 1), []
    for i, tok in enumerate(seq):
        logits, cache = decode(cache, np.array([tok], np.int32),
                               np.array([i + 1], np.int32))
        out.append(np.asarray(logits.cpu() if torch.is_tensor(logits)
                              else logits, np.float32)[0])
    return np.stack(out)


def test_engine_serves_the_smoke_model_as_the_reference(smoke_pair):
    cfg, rapi, rparams, api, params = smoke_pair
    prompts = _prompts(8, 3, 10, seed=7, vocab=cfg.vocab)
    ref_reqs = [RefRequest(i, p, 16) for i, p in enumerate(prompts)]
    reqs = [Request(i, p, 16) for i, p in enumerate(prompts)]
    want = RefEngine(rapi, slots=4, max_len=32).run(rparams, ref_reqs)
    got = ServingEngine(api, slots=4, max_len=32).run(params, reqs)
    assert sorted(got) == sorted(want) == list(range(8))
    rdec = jax.jit(rapi.decode_step)
    compared = 0
    for rid, prompt in enumerate(prompts):
        assert len(got[rid]) == len(want[rid]) == 16
        seq = list(prompt) + want[rid][:-1]
        ref_logits = _teacher_forced(
            lambda c, t, n: rdec(rparams, c, jnp.asarray(t), jnp.asarray(n)),
            rapi.init_cache, seq)
        port_logits = _teacher_forced(
            lambda c, t, n: api.decode_step(params, c, t, n),
            api.init_cache, seq)
        for ref, port in zip(ref_logits, port_logits):
            assert np.abs(port - ref).max() < TOL * np.abs(ref).max()
        # the steps that sample: the last prompt token's and after
        gen = ref_logits[len(prompt) - 1:, :cfg.vocab]
        top2 = np.sort(gen, 1)[:, -2:]
        near = (top2[:, 1] - top2[:, 0]) <= TOL * np.abs(gen).max(1)
        upto = int(np.argmax(near)) if near.any() else len(gen)
        assert got[rid][:upto] == want[rid][:upto], (rid, upto)
        compared += upto
    assert compared >= len(prompts)     # the comparison is not vacuous


def test_serve_launcher_serves_every_request_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "5", "--slots", "2",
                      "--max-new", "4", "--arch", "olmo-1b", "--seed", "3"])
    assert sorted(out) == list(range(5))
    assert all(len(v) == 4 for v in out.values())
    assert "served 5 requests / 20 tokens" in capsys.readouterr().out
