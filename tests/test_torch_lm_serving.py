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
3. ROADMAP C8: prompts of ``max_len - 1``, ``max_len`` and
   ``max_len + 4`` tokens on the qwen3-4b and seamless smoke models: the
   port's engine serves them as the reference's does (the steps past the
   cache within the tolerance of the reference's logits, the same ids
   where the margin is clear).
4. ROADMAP C10: the mamba2 and jamba smoke models' states run on from
   one request to the next in a slot, as in the reference's engine: the
   same ids, and not those of the second request served alone.
5. The DeepSeek-V2 and Jamba smoke models (MLA, routed experts, the
   hybrid's Mamba-2 and attention layers): requests served one after
   another through one slot give the reference's logits at every step
   and its ids up to the first near-tie; with the C8 prompts above too.
   Their reference engines decode with ``xla_allow_excess_precision``
   off, so its bf16 ops round one by one as the port's do
   (``tests/test_torch_moe.py`` says why routing needs it).
6. ``python -m repro_torch.launch.serve --device cpu`` serves every
   request, for a dense, the encoder-decoder, the SSM, the MoE and the
   hybrid smoke config.
"""
import functools
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
ROUTED_ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})
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
    def decode_step(params, cache, token, cur_len, *, past_cache="refuse"):
        assert past_cache == "drop"     # the engine serves past the cache
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


_PAIRS: dict = {}


def _ref_engine(arch, rapi, **kw):
    """The reference's engine; for the routed families its decode step is
    compiled with bf16 ops rounded one by one."""
    eng = RefEngine(rapi, **kw)
    if arch in ROUTED_ARCHS:
        eng.decode = exact_jit(rapi.decode_step)
    return eng


def _pair(arch):
    """(cfg, reference api, reference params, port api, port params) on
    the reference's weights at ``arch``'s smoke config."""
    if arch not in _PAIRS:
        cfg = smoke_config(arch)
        rapi = ref_build_model(ref_smoke_config(arch), remat="none")
        rparams = rapi.init(jax.random.PRNGKey(0))
        _PAIRS[arch] = (cfg, rapi, rparams, build_model(cfg, device="cpu"),
                        params_from_reference(cfg, rparams, device="cpu"))
    return _PAIRS[arch]


@pytest.fixture(scope="module")
def smoke_pair():
    return _pair("qwen3-4b")


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


def _recorded(eng):
    """``eng.decode`` wrapped to keep every step's logits as f32 numpy."""
    inner, steps = eng.decode, []

    def decode(*args, **kw):
        logits, cache = inner(*args, **kw)
        steps.append(np.asarray(logits.cpu() if torch.is_tensor(logits)
                                else logits, np.float32))
        return logits, cache
    eng.decode = decode
    return steps


@pytest.mark.parametrize("arch", ["qwen3-4b", "seamless-m4t-large-v2"]
                         + list(ROUTED_ARCHS))
@pytest.mark.parametrize("extra", [-1, 0, 4])
def test_engine_serves_a_prompt_past_the_cache_as_the_reference(arch, extra):
    """ROADMAP C8: two prompts of max_len + extra and one more token
    through 2 slots of an 8-position cache.  Each request samples once
    (its prompt fills the cache) and stops; every step of an active slot
    is within TOL of the reference's logits, and the ids agree wherever
    the reference's top-2 margin exceeds twice the largest gap between
    the two engines' logits (there the argmax cannot differ)."""
    cfg, rapi, rparams, api, params = _pair(arch)
    max_len = 8
    lens = (max_len + extra, max_len + extra + 1)
    rng = np.random.default_rng(21 + extra)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    ref_eng = _ref_engine(arch, rapi, slots=2, max_len=max_len)
    eng = ServingEngine(api, slots=2, max_len=max_len)
    ref_steps, steps = _recorded(ref_eng), _recorded(eng)
    want = ref_eng.run(rparams, [RefRequest(i, p, 4)
                                 for i, p in enumerate(prompts)])
    got = eng.run(params, [Request(i, p, 4) for i, p in enumerate(prompts)])
    assert sorted(got) == sorted(want) == [0, 1]
    assert len(steps) == len(ref_steps) == lens[1]
    clear = 0
    for slot, n in enumerate(lens):
        assert len(got[slot]) == len(want[slot]) == 1
        for t in range(n):                  # the slot is active
            ref = ref_steps[t][slot]
            assert np.abs(steps[t][slot] - ref).max() < \
                TOL * np.abs(ref).max(), (slot, t)
        ref = ref_steps[n - 1][slot, :cfg.vocab]
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 2 * np.abs(steps[n - 1][slot, :cfg.vocab]
                                          - ref).max():
            assert got[slot] == want[slot], slot
            clear += 1
    assert clear                            # the comparison is not vacuous


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_ssm_engine_carries_the_state_across_requests_as_the_reference(arch):
    """ROADMAP C10: neither engine resets a slot's state when it takes a
    request, so request 1 after request 0 in one slot runs on request 0's
    state.  The port's ids equal the reference's both ways, and differ
    from request 1 served alone."""
    cfg, rapi, rparams, api, params = _pair(arch)
    prompts = _prompts(2, 4, 9, seed=11, vocab=cfg.vocab)

    def both(ps):
        want = _ref_engine(arch, rapi, slots=1, max_len=32).run(
            rparams, [RefRequest(i, p, 4) for i, p in enumerate(ps)])
        got = ServingEngine(api, slots=1, max_len=32).run(
            params, [Request(i, p, 4) for i, p in enumerate(ps)])
        assert got == want
        return got

    after = both(prompts)
    alone = both(prompts[1:])
    assert after[1] != alone[0]


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "mamba2-130m",
                                  "deepseek-v2-236b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_serve_launcher_serves_the_new_families_on_the_cpu(arch, capsys):
    out = serve.main(["--device", "cpu", "--requests", "3", "--slots", "2",
                      "--max-new", "4", "--arch", arch, "--seed", "3"])
    assert sorted(out) == list(range(3))
    assert all(len(v) == 4 for v in out.values())
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_serve_launcher_serves_every_request_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "5", "--slots", "2",
                      "--max-new", "4", "--arch", "olmo-1b", "--seed", "3"])
    assert sorted(out) == list(range(5))
    assert all(len(v) == 4 for v in out.values())
    assert "served 5 requests / 20 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ROUTED_ARCHS)
def test_engine_serves_the_routed_families_as_the_reference(arch):
    """Four requests one after another through one slot (the hybrid's
    state carried from each to the next): the port's logits are within
    TOL of the reference's at every step, and each sampled id equals the
    reference's wherever its top-2 margin exceeds twice the largest gap
    between the two engines' logits (there the argmax cannot differ),
    up to the first step where it does not."""
    cfg, rapi, rparams, api, params = _pair(arch)
    prompts = _prompts(4, 3, 9, seed=13, vocab=cfg.vocab)
    ref_eng = _ref_engine(arch, rapi, slots=1, max_len=32)
    eng = ServingEngine(api, slots=1, max_len=32)
    ref_steps, steps = _recorded(ref_eng), _recorded(eng)
    want = ref_eng.run(rparams, [RefRequest(i, p, 6)
                                 for i, p in enumerate(prompts)])
    got = eng.run(params, [Request(i, p, 6) for i, p in enumerate(prompts)])
    assert sorted(got) == sorted(want) == list(range(4))
    clear = _clear_ids_agree(cfg, prompts, want, got, ref_steps, steps)
    assert clear >= len(prompts)        # the comparison is not vacuous


def _clear_ids_agree(cfg, prompts, want, got, ref_steps, steps) -> int:
    """Walk one slot's steps request by request: every step's logits
    within TOL, and each sampled id equal to the reference's while its
    top-2 margin exceeds twice the gap; the count of ids compared."""
    t, clear = 0, 0
    for rid, prompt in enumerate(prompts):
        n_steps = len(prompt) + len(want[rid]) - 1
        for j in range(n_steps):
            ref, port = ref_steps[t + j][0], steps[t + j][0]
            gap = np.abs(port - ref).max()
            assert gap < TOL * np.abs(ref).max(), (rid, j)
            k = j - (len(prompt) - 1)           # the id this step samples
            if k < 0:
                continue
            top2 = np.sort(ref[:cfg.vocab])[-2:]
            if top2[1] - top2[0] <= 2 * gap:
                return clear                    # ids may part from here
            assert got[rid][k] == want[rid][k], (rid, k)
            clear += 1
        t += n_steps
    return clear
