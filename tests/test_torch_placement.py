"""The placements on a mesh against the reference's (ROADMAP A9 (d), (e)).

``configs.sharding``, ``models.placement``, ``moe_forward``'s
expert-parallel branch, every family's ``loss``, ``prefill`` and
``decode_step`` on a ``DeviceMesh`` (long-context decode too: a batch
the DP ranks do not divide, its cache split on the sequence axis), the
train step on placed state and
checkpoints across meshes, run as gloo ranks on the CPU (one process a
rank, a file rendezvous), against the reference on 4 fake CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), whose routed
cases are compiled with ``xla_allow_excess_precision`` off (ROADMAP C11).

The parameters are seeded numpy draws on the reference's trees
(``fill``).  The reference runs in three module-scoped subprocesses side
by side: one first writes every input (the parameter trees, the
batches, the reference's own shards of two placed models) to
``inputs.npz``, then computes the MoE cases and the losses; the second
the serving and train cases; the third the long-context cases.  The port's ranks start as soon as the
inputs exist, once for world 2 and once for world 4, and run while the
reference computes; each rank writes its npz and the assertions are
made here.  Every process started here runs under a deadline.

Run as a script (``python tests/test_torch_placement.py DIR WORLD``)
this file is one rank of the port's side: it imports torch and the
port, never jax nor the reference.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_TIMEOUT_S = 600
RANKS_TIMEOUT_S = 600
TOL = 4e-2               # tests/test_torch_models.py's, of max |reference|
MOE_TOL = 2e-2           # tests/test_torch_moe.py's
LOSS_RTOL = 1e-3         # tests/test_torch_train_step.py's
ROUTED_TOL = 4e-2
GNORM_RTOL = 1e-2
GRAD_TOL = 5e-2
LR = 1e-3
VOCAB = 500
MOE_ARCH = "deepseek-v2-236b"
#: case -> (mesh shape, x shape (B, S)): a decode step and a prefill on
#: each mesh, and a batch that dp 2 cannot split
MOE_CASES = {f"{m[0]}x{m[1]}/{kind}": (m, x)
             for m in ((1, 2), (2, 2), (4, 1))
             for kind, x in (("decode", (4, 1)), ("prefill", (4, 16)))}
MOE_CASES["2x2/unshardable"] = ((2, 2), (3, 16))
#: one smoke config a family
LOSS_ARCHS = ("qwen3-4b", "paligemma-3b", "seamless-m4t-large-v2",
              "mamba2-130m", "deepseek-v2-236b", "jamba-v0.1-52b")
SERVE_ARCHS = ("qwen3-4b", "deepseek-v2-236b")
TRAIN_ARCHS = ("olmo-1b", "deepseek-v2-236b")
ROUTED = ("deepseek-v2-236b", "deepseek-v3-671b", "jamba-v0.1-52b")
#: world -> (mesh shape, dim names, FSDP dims) of the shard comparison
SHARD_MESHES = {"2x2": ((2, 2), ("data", "model"), ("data",)),
                "pod": ((2, 1, 2), ("pod", "data", "model"),
                        ("pod", "data"))}
SHARD_ARCHS = ("deepseek-v2-236b", "jamba-v0.1-52b")
B, S, SMAX, S_ENC, DECODE_STEPS = 4, 16, 24, 10, 2
#: long-context decode (A9 (e)): every family with a KV cache, and the
#: SSM, whose state has no sequence axis
LC_ARCHS = ("qwen3-4b", "paligemma-3b", "seamless-m4t-large-v2",
            "deepseek-v2-236b", "jamba-v0.1-52b")
LC_SSM = "mamba2-130m"
#: case -> (mesh shape, batch): batches the DP ranks do not divide, so
#: ``cache_specs`` splits the SMAX positions (and the 12 encoder
#: positions of the cross cache) over "data": 6 a rank on (4, 1), 12 on
#: (2, 2), where the prefill's 16 are 4 and 8 a rank
LC_CASES = {"4x1": ((4, 1), 1), "2x2": ((2, 2), 3)}
LC_S_ENC, LC_WIDE = 12, 96
DROP_ARCH = "qwen3-4b"


def make_batch(cfg, seed, b=B, s=S, s_enc=S_ENC):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.prefix_len:
        batch["patches"] = rng.standard_normal(
            (b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (b, s_enc, cfg.d_model)).astype(np.float32)
    return batch


def decode_tokens(cfg, b=B):
    rng = np.random.default_rng(5)
    return rng.integers(0, cfg.vocab, (DECODE_STEPS, b)).astype(np.int32)


def lc_batch(cfg, b):
    """A long-context case's prefill batch: S positions in all (the
    VLM's prefix among them)."""
    return make_batch(cfg, 7, b=b, s=S - cfg.prefix_len, s_enc=LC_S_ENC)


def lc_init_kw(cfg) -> dict:
    return {"enc_len": LC_S_ENC} if cfg.family == "encdec" else {}


def kv_paths(cache, prefix="") -> list:
    """The paths (``a/b``) of a cache's leaves that have a sequence axis:
    every dict leaf but the hybrid's ``ssm`` states and ``len``."""
    out = []
    for k, v in cache.items():
        if k in ("ssm", "len"):
            continue
        if isinstance(v, dict):
            out += kv_paths(v, f"{prefix}{k}/")
        else:
            out.append(prefix + k)
    return out


def at_path(cache, path):
    for k in path.split("/"):
        cache = cache[k]
    return cache


#: leaves drawn as gains, 1 + N(0, 0.1) (the rest N(0, 1) / sqrt(fan-in))
GAINS = ("q_gamma", "k_gamma", "n1", "nx", "n2", "final_norm", "enc_norm",
         "norm", "D", "dt_bias", "A_log", "q_norm", "kv_norm", "ffn_norms")


def fill(shapes, seed: int) -> dict:
    """A parameter tree of ``shapes`` (a nested dict of shaped leaves,
    ``jax.eval_shape``'s) drawn from numpy with ``seed``, in the tree's
    key order: the gains near 1, every other leaf N(0, 1) over the root
    of its fan-in (its second-to-last dim)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif v is None:
                out[k] = None
            elif k in GAINS or len(v.shape) < 2:
                out[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)
                          ).astype(np.float32)
            else:
                out[k] = (rng.standard_normal(v.shape)
                          / np.sqrt(v.shape[-2])).astype(np.float32)
        return out
    return walk(shapes)


def flat(tree, prefix: str) -> dict:
    """A nested dict of arrays (None leaves dropped) as ``{prefix/path:
    f32 array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}/{k}"))
        elif v is not None:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


def nest(z, prefix: str) -> dict:
    """``flat``'s inverse over the keys of ``z`` under ``prefix``."""
    out: dict = {}
    for key in z:
        if not key.startswith(prefix + "/"):
            continue
        node, parts = out, key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = z[key]
    return out


# ------------------------------------------------------------ reference ---
REFERENCE = r'''
import importlib.util, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[3])
import functools
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import smoke_config
from repro.configs import sharding as SH
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.models import moe as MOE
from repro.train.optimizer import adamw_init
from repro.train.train_step import TrainState, make_train_step
spec = importlib.util.spec_from_file_location("cases", sys.argv[4])
T = importlib.util.module_from_spec(spec)
spec.loader.exec_module(T)
part = sys.argv[5]
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})
key = jax.random.PRNGKey(0)


def shapes(init):
    return jax.tree.map(lambda a: a, jax.eval_shape(init, key))


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


cfg = smoke_config(T.MOE_ARCH)
moe_p = T.fill(shapes(lambda k: MOE.init_moe(k, cfg)), 0)
params = {arch: T.fill(shapes(build_model(smoke_config(arch)).init), 1)
          for arch in sorted(set(T.LOSS_ARCHS + T.SERVE_ARCHS
                                 + T.SHARD_ARCHS))}
train = {arch: T.fill(shapes(build_model(
             smoke_config(arch).scaled(vocab=T.VOCAB)).init), 2)
         for arch in T.TRAIN_ARCHS}
inputs, out = {}, {}
if part == "inputs":
    # written first: the ranks start on them while the rest is computed
    inputs.update(T.flat(moe_p, "moe/params"))
    for case, (_, shape) in T.MOE_CASES.items():
        x = np.random.default_rng(len(case)).standard_normal(
            shape + (cfg.d_model,)).astype(np.float32)
        inputs[f"moe/x/{case}"] = np.asarray(
            jnp.asarray(x, jnp.bfloat16), np.float32)
    for arch, p in params.items():
        inputs.update(T.flat(p, f"arch/{arch}/params"))
        for k, v in T.make_batch(smoke_config(arch), 1).items():
            inputs[f"arch/{arch}/batch/{k}"] = v
    for arch, p in train.items():
        inputs.update(T.flat(p, f"train/{arch}/params"))
        c = smoke_config(arch).scaled(vocab=T.VOCAB)
        for k, v in T.make_batch(c, 2).items():
            inputs[f"train/{arch}/batch/{k}"] = v
    devs = jax.devices()
    for world, (shape, names, fsdp) in T.SHARD_MESHES.items():
        mesh = Mesh(np.asarray(devs[:4]).reshape(shape), names)
        for arch in T.SHARD_ARCHS:
            specs = SH.param_specs(params[arch], mesh, fsdp=fsdp)
            placed = jax.tree.map(
                lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
                params[arch], specs)
            for r in range(4):
                local = jax.tree.map(
                    lambda a: next(s.data for s in a.addressable_shards
                                   if s.device == devs[r]), placed)
                inputs.update(T.flat(local, f"shards/{world}/{arch}/{r}"))
    np.savez(sys.argv[1] + ".tmp.npz", **inputs)
    os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])
    for case, (shape, _) in T.MOE_CASES.items():
        mesh = make_host_mesh(*shape)
        fn = exact_jit(lambda p, x: MOE.moe_forward(p, cfg, x, mesh=mesh))
        o, aux = fn(as_jax(moe_p),
                    jnp.asarray(inputs[f"moe/x/{case}"], jnp.bfloat16))
        out[f"moe/{case}/out"] = np.asarray(o, np.float32)
        out[f"moe/{case}/aux"] = np.asarray(aux, np.float32)
    mesh = make_host_mesh(2, 2)
    for arch in T.LOSS_ARCHS:
        api = build_model(smoke_config(arch), mesh=mesh)
        batch = {k: jnp.asarray(v) for k, v in
                 T.make_batch(smoke_config(arch), 1).items()}
        loss, _ = exact_jit(api.loss)(as_jax(params[arch]), batch)
        out[f"loss/{arch}"] = np.asarray(loss, np.float32)
elif part == "steps":
    mesh = make_host_mesh(2, 2)
    for arch in T.SERVE_ARCHS:
        c = smoke_config(arch)
        api = build_model(c, mesh=mesh)
        p = as_jax(params[arch])
        batch = {k: jnp.asarray(v) for k, v in T.make_batch(c, 1).items()}
        logits, pc = exact_jit(api.prefill)(p, batch)
        out[f"serve/{arch}/prefill"] = np.asarray(logits, np.float32)
        cache = jax.tree.map(lambda z, p: z.at[:, :, :T.S].set(p),
                             api.init_cache(T.B, T.SMAX),
                             {k: v for k, v in pc.items() if k != "len"})
        step = exact_jit(api.decode_step)
        for t, tok in enumerate(T.decode_tokens(c)):
            logits, cache = step(p, cache, jnp.asarray(tok),
                                 jnp.asarray(T.S + 1 + t, jnp.int32))
            out[f"serve/{arch}/decode{t}"] = np.asarray(logits, np.float32)
    for arch in T.TRAIN_ARCHS:
        c = smoke_config(arch).scaled(vocab=T.VOCAB)
        api = build_model(c, mesh=mesh)
        p = as_jax(train[arch])
        state = TrainState(p, adamw_init(p), jnp.zeros((), jnp.int32))
        step = exact_jit(make_train_step(api, lr_fn=lambda s: T.LR))
        batch = {k: jnp.asarray(v) for k, v in T.make_batch(c, 2).items()}
        new, m = step(state, batch)
        out[f"train/{arch}/loss"] = np.asarray(m["loss"], np.float32)
        out[f"train/{arch}/gnorm"] = np.asarray(m["gnorm"], np.float32)
        out.update(T.flat(new.params, f"train/{arch}/new"))
        out.update(T.flat(new.opt["m"], f"train/{arch}/m"))
        if arch in T.ROUTED:
            # the reference's own spread: the same step compiled with
            # excess precision on routes some tokens elsewhere (C11)
            other, _ = jax.jit(make_train_step(api, lr_fn=lambda s: T.LR))(
                state, batch)
            out[f"train/{arch}/self_gap"] = np.float32(max(
                float(np.abs(np.asarray(a) - np.asarray(b)).max()
                      / max(float(np.abs(np.asarray(a)).max()), 1e-30))
                for a, b in zip(jax.tree.leaves(new.opt["m"]),
                                jax.tree.leaves(other.opt["m"]))))
elif part == "long":
    from jax.sharding import PartitionSpec
    devs = jax.devices()

    def specs(cache, mesh):
        """The port's cache placements: ``cache_specs`` on the K/V leaves,
        the SSM states replicated."""
        if isinstance(cache, tuple):
            return jax.tree.map(lambda x: PartitionSpec(), cache)
        return {k: specs(v, mesh) if k == "ssm" else
                SH.cache_specs(v, mesh) for k, v in cache.items()}

    def placed(cache, mesh):
        return jax.device_put(cache, SH.named(mesh, specs(cache, mesh)))

    def grown(arch, api, pc, b, smax):
        """The prefill's cache copied into an ``smax``-position one."""
        c = smoke_config(arch)
        if c.family == "ssm":
            return pc
        z = api.init_cache(b, smax, **T.lc_init_kw(c))
        pc = {k: v for k, v in pc.items() if k != "len"}
        return jax.tree.map(
            lambda a, p: p if a.shape == p.shape else
            a.at[:, :, :p.shape[2]].set(p), z, pc)

    for arch in T.LC_ARCHS + (T.LC_SSM,):
        c = smoke_config(arch)
        p = as_jax(params[arch])
        for case, (shape, b) in T.LC_CASES.items():
            if arch == T.LC_SSM and case != "4x1":
                continue
            mesh = make_host_mesh(*shape)
            api = build_model(c, mesh=mesh)
            batch = {k: jnp.asarray(v) for k, v in T.lc_batch(c, b).items()}
            key = f"lc/{arch}/{case}"
            logits, pc = exact_jit(api.prefill)(p, batch)
            out[f"{key}/prefill"] = np.asarray(logits, np.float32)
            cache = placed(grown(arch, api, pc, b, T.SMAX), mesh)
            start = cache
            step = exact_jit(api.decode_step)
            for t, tok in enumerate(T.decode_tokens(c, b)):
                logits, cache = step(p, cache, jnp.asarray(tok),
                                     jnp.asarray(T.S + 1 + t, jnp.int32))
                out[f"{key}/decode{t}"] = np.asarray(logits, np.float32)
            if c.family != "ssm":
                cache = placed(cache, mesh)
                for path in T.kv_paths(cache):
                    leaf = T.at_path(cache, path)
                    for r in range(4):
                        out[f"{key}/shard/{r}/{path}"] = np.asarray(next(
                            s.data for s in leaf.addressable_shards
                            if s.device == devs[r]), np.float32)
            if arch == T.DROP_ARCH and case == "4x1":
                # a step past the cache: the reference's scatter drops
                logits, after = step(p, start, jnp.asarray(
                    T.decode_tokens(c, b)[0]), jnp.asarray(T.SMAX + 2,
                                                           jnp.int32))
                out[f"{key}/drop"] = np.asarray(logits, np.float32)
                out[f"{key}/drop_cache"] = np.asarray(after["k"], np.float32)
np.savez(sys.argv[2], **out)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, inputs, world 2's ranks, world 4's ranks):
    three reference subprocesses started first (the one that writes the
    inputs, then the MoE cases and the losses; the serving and train
    cases; the long-context cases), the ranks on the inputs while they
    compute."""
    from repro_torch.launch.ranks import run_ranks

    tmp = tmp_path_factory.mktemp("placement")
    inputs = tmp / "inputs.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    procs = []
    for part in ("inputs", "steps", "long"):
        err = open(tmp / f"reference_{part}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", REFERENCE, str(inputs),
             str(tmp / f"ref_{part}.npz"), str(ROOT / "src"), __file__, part],
            stdout=subprocess.DEVNULL, stderr=err, env=env, cwd=ROOT), err))
    deadline = time.monotonic() + REFERENCE_TIMEOUT_S
    try:
        while not inputs.exists():
            for proc, err in procs:
                assert proc.poll() in (None, 0), _tail(err)
            assert time.monotonic() < deadline, "no reference inputs"
            time.sleep(0.2)
        port_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        port_env.pop("XLA_FLAGS", None)
        worlds = {}
        for world in (2, 4):
            outdir = tmp / f"world{world}"
            run_ranks([sys.executable, __file__, str(tmp), str(world)],
                      world, workdir=outdir, timeout_s=RANKS_TIMEOUT_S,
                      env=port_env, cwd=ROOT)
            worlds[world] = [_load(outdir / f"rank{r}.npz")
                             for r in range(world)]
        for proc, err in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            assert proc.returncode == 0, _tail(err)
    finally:
        for proc, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    with np.load(inputs) as z:
        ins = dict(z)
    ref = {**_load(tmp / "ref_inputs.npz"), **_load(tmp / "ref_steps.npz"),
           **_load(tmp / "ref_long.npz")}
    return ref, ins, worlds[2], worlds[4]


def _tail(f) -> str:
    f.flush()
    f.seek(0)
    return f.read()[-4000:]


def _load(path) -> dict:
    with np.load(path) as z:
        out = dict(z)
    if "errors" in out:
        out["errors"] = json.loads(str(out["errors"]))
    return out


# ----------------------------------------------------------------- port ---
def _np(t) -> np.ndarray:
    import torch
    return t.detach().to(torch.float32).cpu().numpy()


def _gather(t):
    from repro_torch.models import placement as P
    return _np(P.full(t))


def _refuse(fn) -> list:
    try:
        fn()
    except Exception as exc:        # noqa: BLE001 - recorded, not hidden
        return [type(exc).__name__, str(exc)]
    return ["", ""]


def _moe_layer(cfg, z, mesh):
    """The reference's MoE layer as the port's ``MoE``, placed on
    ``mesh`` as a model's MoE layer is."""
    import torch
    from repro_torch.configs.sharding import leaf_spec
    from repro_torch.models import moe as TMOE
    from repro_torch.models import placement as P
    layer = TMOE.MoE(cfg)
    ref = nest(z, "moe/params")
    with torch.no_grad():
        for name, p in layer.named_parameters():
            src = ref
            for part in name.split("."):
                src = src[part]
            p.copy_(torch.from_numpy(src))
    specs = {n: leaf_spec("moe." + n, p.shape, mesh)
             for n, p in layer.named_parameters()}
    return P.place_module(layer, mesh, specs)


def _moe_cases(z, meshes, out):
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe as TMOE
    from repro_torch.models import placement as P
    cfg = smoke_config(MOE_ARCH)
    for case, (shape, xshape) in MOE_CASES.items():
        if shape not in meshes:
            continue
        mesh = meshes[shape]
        layer = _moe_layer(cfg, z, mesh)
        x = torch.from_numpy(z[f"moe/x/{case}"]).to(torch.bfloat16)
        rows = P.Rows(mesh, ("data",), xshape[0])
        with torch.no_grad():
            o, aux = TMOE.moe_forward(layer, cfg, rows.take(x), mesh=mesh,
                                      global_batch=xshape[0])
        out[f"moe/{case}/out"] = _gather(rows.out(o))
        out[f"moe/{case}/aux"] = _np(aux)


def _moe_grads(z, mesh, errors):
    """The expert-parallel branch's backward at (1, 2), where its forward
    is the mesh-free capacity path's: the gradients of x, the router and
    the expert stacks (whole on each rank, the train step's working
    copy) against the mesh-free ones on the same rank."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.models import moe as TMOE
    cfg = smoke_config(MOE_ARCH)
    case = "1x2/prefill"
    layer = TMOE.MoE(cfg)
    ref = nest(z, "moe/params")
    for name, p in layer.named_parameters():
        src = ref
        for part in name.split("."):
            src = src[part]
        p.data = torch.from_numpy(src).to(torch.bfloat16)
        p.requires_grad_(True)
    x0 = torch.from_numpy(z[f"moe/x/{case}"]).to(torch.bfloat16)
    w = torch.randn(x0.shape, generator=torch.Generator().manual_seed(3))
    grads = []
    for m in (None, mesh):
        x = x0.clone().requires_grad_(True)
        o, aux = TMOE.moe_forward(layer, cfg, x, mesh=m)
        loss = (o.float() * w).sum() + 100 * aux
        params = [x] + list(layer.parameters())
        grads.append([g.float() for g in torch.autograd.grad(loss, params)])
    names = ["x"] + [n for n, _ in layer.named_parameters()]
    m, n_local = mesh.get_local_rank("model"), cfg.moe.n_experts // 2
    gaps, others = {}, 0.0
    for n, a, b in zip(names, grads[1], grads[0]):
        if n in TMOE.MoE.expert_stacks:
            # a rank's expert gradients: its own experts' rows, the rest 0
            mine = slice(m * n_local, (m + 1) * n_local)
            rest = torch.ones(a.shape[0], dtype=torch.bool)
            rest[mine] = False
            others = max(others, float(a[rest].abs().max()))
            a, b = a[mine], b[mine]
        gaps[n] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    errors["moe_grads"] = gaps
    errors["moe_grads_other_experts"] = others


def _shards(z, out, errors):
    """Each placed parameter's local shard against the reference's shard
    on the device at this rank's coordinates."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import placement as P
    rank = dist.get_rank()
    for world, (shape, names, fsdp) in SHARD_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for arch in SHARD_ARCHS:
            model = params_from_reference(
                smoke_config(arch), nest(z, f"arch/{arch}/params"),
                device="cpu", mesh=mesh, dp_axes=fsdp)
            ref = nest(z, f"shards/{world}/{arch}/{rank}")
            bad, n = [], 0
            for name, p in model.named_parameters():
                parts = name.split(".")
                leaf = ref
                for q in parts:
                    if not q.isdigit():
                        leaf = leaf[q]
                idx = tuple(int(q) for q in parts if q.isdigit())
                want = torch.from_numpy(np.ascontiguousarray(leaf[idx]))
                got = P.local(p)
                n += 1
                if got.shape != want.shape or not torch.equal(
                        got, want.to(got.dtype)):
                    bad.append([name, list(got.shape), list(want.shape)])
            errors[f"shards/{world}/{arch}"] = {"n": n, "bad": bad}


def _losses(z, mesh, out):
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import build_model
    for arch in LOSS_ARCHS:
        cfg = smoke_config(arch)
        api = build_model(cfg, mesh=mesh, device="cpu")
        params = params_from_reference(cfg, nest(z, f"arch/{arch}/params"),
                                       device="cpu", mesh=mesh)
        with torch.no_grad():
            loss, _ = api.loss(params, nest(z, f"arch/{arch}/batch"))
        out[f"loss/{arch}"] = _np(loss)


def _serve(z, mesh, out):
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import build_model
    from repro_torch.models import placement as P
    for arch in SERVE_ARCHS:
        cfg = smoke_config(arch)
        api = build_model(cfg, mesh=mesh, device="cpu")
        params = params_from_reference(cfg, nest(z, f"arch/{arch}/params"),
                                       device="cpu", mesh=mesh)
        with torch.no_grad():
            logits, pc = api.prefill(params, nest(z, f"arch/{arch}/batch"))
            out[f"serve/{arch}/prefill"] = _gather(logits)
            cache = api.init_cache(B, SMAX)
            _copy_prefix(P.local_tree(cache), P.local_tree(pc))
            for t, tok in enumerate(decode_tokens(cfg)):
                logits, cache = api.decode_step(params, cache, tok, S + 1 + t)
                out[f"serve/{arch}/decode{t}"] = _gather(logits)


def _copy_prefix(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _copy_prefix(dst[k], src[k])
    else:
        dst[:, :, :src.shape[2]].copy_(src)


def _grown(api, cfg, pc, b, smax):
    """The prefill's cache copied into an ``smax``-position one, each
    placed by ``cache_specs`` (``testing.long_context.copy_prefix``: the
    two lengths split their positions differently); the SSM's states as
    they are."""
    from repro_torch.models import placement as P
    from repro_torch.testing.long_context import copy_prefix
    if cfg.family == "ssm":
        return pc
    cache = api.init_cache(b, smax, **lc_init_kw(cfg))
    for path in kv_paths(cache):
        copy_prefix(at_path(cache, path), at_path(pc, path))
    if "ssm" in cache:
        for dst, src in zip(cache["ssm"], pc["ssm"]):
            P.local(dst).copy_(P.local(src))
    return cache


def _exchange(api, params, cfg, smax) -> dict:
    """The collective bytes by kind of one decode step at batch 1 over an
    ``smax``-position cache (``launch.hlo_cost``'s counter)."""
    import torch
    from repro_torch.launch.hlo_cost import CostCounter
    cache = api.init_cache(1, smax, **lc_init_kw(cfg))
    with torch.no_grad(), CostCounter() as c:
        api.decode_step(params, cache, decode_tokens(cfg, 1)[0], S + 1)
    return c.totals()["collectives"]


def _long_context(z, meshes, out, errors):
    """A9 (e): every KV family (and the SSM) at a batch the DP ranks do
    not divide, prefill then decode on its sequence-sharded cache."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.convert import params_from_reference
    from repro_torch.models import build_model
    from repro_torch.models import placement as P
    rank = dist.get_rank()
    for arch in LC_ARCHS + (LC_SSM,):
        cfg = smoke_config(arch)
        ref_params = nest(z, f"arch/{arch}/params")
        for case, (shape, b) in LC_CASES.items():
            if arch == LC_SSM and case != "4x1":
                continue
            mesh, key = meshes[shape], f"lc/{arch}/{case}"
            api = build_model(cfg, mesh=mesh, device="cpu")
            params = params_from_reference(cfg, ref_params, device="cpu",
                                           mesh=mesh)
            with torch.no_grad():
                logits, pc = api.prefill(params, lc_batch(cfg, b))
                out[f"{key}/prefill"] = _gather(logits)
                cache = _grown(api, cfg, pc, b, SMAX)
                for t, tok in enumerate(decode_tokens(cfg, b)):
                    logits, cache = api.decode_step(params, cache, tok,
                                                    S + 1 + t)
                    out[f"{key}/decode{t}"] = _gather(logits)
                if cfg.family == "ssm":
                    errors[f"{key}/state"] = [_kinds(t.placements)
                                              for t in cache]
                    continue
                errors[f"{key}/placements"] = {
                    path: _kinds(at_path(cache, path).placements)
                    for path in kv_paths(cache)}
                for path in kv_paths(cache):
                    out[f"{key}/shard/{rank}/{path}"] = _np(
                        P.local(at_path(cache, path)))
                if arch == DROP_ARCH and case == "4x1":
                    fresh = _grown(api, cfg, pc, b, SMAX)
                    logits, after = api.decode_step(
                        params, fresh, decode_tokens(cfg, b)[0], SMAX + 2,
                        past_cache="drop")
                    out[f"{key}/drop"] = _gather(logits)
                    out[f"{key}/drop_cache"] = _gather(after["k"])
            if case == "4x1" and cfg.family != "ssm":
                errors[f"{key}/exchange"] = [
                    _exchange(api, params, cfg, n) for n in (SMAX, LC_WIDE)]
    api = build_model(smoke_config("qwen3-4b"), mesh=meshes[(2, 2)],
                      device="cpu")
    errors["long_context_ok"] = [
        _refuse(lambda: api.init_cache(1, 7)),
        _kinds(api.init_cache(1, 7)["k"].placements)]


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v)
            for k, v in tree.items()}


def _initial(z, arch):
    """The reference's initial train state: its masters, zero moments."""
    params = nest(z, f"train/{arch}/params")
    return SimpleNamespace(params=params, step=0, opt={
        "m": _zeros(params), "v": _zeros(params), "step": 0})


def _train(z, meshes, outdir, out, errors):
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.convert import train_state_from_reference
    from repro_torch.models import build_model
    from repro_torch.models import placement as P
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_step import (make_train_step,
                                              state_shardings)
    rank = dist.get_rank()
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(arch).scaled(vocab=VOCAB)

        def state_on(mesh):
            return train_state_from_reference(cfg, _initial(z, arch),
                                              device="cpu", mesh=mesh)

        api = build_model(cfg, mesh=meshes[(2, 2)], device="cpu")
        step = make_train_step(api, lr_fn=lambda s: LR)
        new, m = step(state_on(meshes[(2, 2)]),
                      nest(z, f"train/{arch}/batch"))
        out[f"train/{arch}/loss"] = _np(m["loss"])
        out[f"train/{arch}/gnorm"] = _np(m["gnorm"])
        full = {n: _gather(p) for n, p in new.params.items()}
        out.update({f"train/{arch}/new/{n}": v for n, v in full.items()})
        out.update({f"train/{arch}/m/{n}": _gather(t)
                    for n, t in new.opt["m"].items()})
        held = sum(P.local(p).numel() for p in new.params.values())
        errors[f"train/{arch}/held"] = [held, sum(
            p.numel() for p in new.params.values())]
        directory = str(Path(outdir) / f"ckpt_{arch}")
        ckpt.save(new, directory, 1)
        template = state_on(meshes[(4, 1)])
        onto, s = ckpt.restore(template, directory,
                               shardings=state_shardings(template))
        errors[f"train/{arch}/restored_4x1"] = [s, sorted(
            n for n, p in onto.params.items()
            if not np.array_equal(_gather(p), full[n])), sorted(
            n for n, p in onto.opt["m"].items()
            if not np.array_equal(_gather(p),
                                  out[f"train/{arch}/m/{n}"]))]
        if rank == 0:
            plain = train_state_from_reference(cfg, _initial(z, arch),
                                               device="cpu")
            one, s = ckpt.restore(plain, directory, shardings="cpu")
            errors[f"train/{arch}/restored_one"] = [s, sorted(
                n for n, p in one.params.items()
                if P.is_placed(p) or not np.array_equal(_np(p), full[n]))]


def _kinds(placements) -> list:
    """Each placement as ``["shard", dim]`` or ``["replicate"]``."""
    return [["shard", p.dim] if p.is_shard() else ["replicate"]
            for p in placements]


def _rank_main(tmp: str, world: int) -> None:
    """One rank of the port's side: every case of this world size."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.ranks import join
    from repro_torch.models.layers import make_constrainer

    rank, world = join("gloo")
    torch.manual_seed(0)
    outdir = Path(tmp) / f"world{world}"
    with np.load(Path(tmp) / "inputs.npz") as f:
        z = dict(f)
    out, errors = {}, {}
    if world == 2:
        meshes = {(1, 2): make_host_mesh(1, 2, device_type="cpu")}
        _moe_cases(z, meshes, out)
        _moe_grads(z, meshes[(1, 2)], errors)
    else:
        meshes = {(2, 2): make_host_mesh(2, 2, device_type="cpu"),
                  (4, 1): make_host_mesh(4, 1, device_type="cpu")}
        _moe_cases(z, meshes, out)
        _shards(z, out, errors)
        _losses(z, meshes[(2, 2)], out)
        _serve(z, meshes[(2, 2)], out)
        _train(z, meshes, outdir, out, errors)
        _long_context(z, meshes, out, errors)
        mesh = meshes[(2, 2)]
        # the activation pin on a DTensor: rows over "data"
        x = DTensor.from_local(torch.arange(8.0).reshape(4, 2), mesh,
                               [Replicate(), Replicate()])
        pinned = make_constrainer(mesh, ("data",))(x)
        odd = DTensor.from_local(torch.zeros(3, 2), mesh,
                                 [Replicate(), Replicate()])
        errors["constrain"] = [
            _kinds(pinned.placements),
            bool(torch.equal(pinned.full_tensor(), x.full_tensor())),
            _kinds(make_constrainer(mesh, ("data",))(odd).placements)]
    errors["foreign"] = sorted(m for m in sys.modules if m == "jax" or
                               m.startswith(("jax.", "repro.")))
    out["errors"] = np.asarray(json.dumps(errors))
    np.savez(outdir / f"rank{rank}.npz", **out)


# ---------------------------------------------------------------- tests ---
def _rel(ref, got) -> float:
    ref, got = np.asarray(ref, np.float32), np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mesh_branch_matches_reference(case, runs):
    """``moe_forward`` on a (data, model) mesh against the reference's
    ``shard_map`` (and, for a batch dp 2 cannot split, its fallback to
    the mesh-free code): the output within ``MOE_TOL`` of its max, the
    aux loss within 1e-5 relative; every rank gives the same."""
    ref, _, w2, w4 = runs
    outs = w2 if MOE_CASES[case][0] == (1, 2) else w4
    got = outs[0]
    assert _rel(ref[f"moe/{case}/out"], got[f"moe/{case}/out"]) < MOE_TOL
    np.testing.assert_allclose(got[f"moe/{case}/aux"],
                               ref[f"moe/{case}/aux"], rtol=1e-5)
    for other in outs[1:]:
        np.testing.assert_array_equal(other[f"moe/{case}/out"],
                                      got[f"moe/{case}/out"])


def test_moe_mesh_branch_backward_is_the_mesh_free_one(runs):
    """At (1, 2) and 64 tokens the expert-parallel forward is the
    mesh-free capacity path, so its backward (the tokens' and the
    probabilities' cotangents summed over the "model" ranks, the output's
    passed through) must give the mesh-free gradients of x, the router,
    the rank's own experts and the shared experts: within 1e-2 of each
    one's max (bf16 grads, another order of f32 sums); the other
    experts' rows get none (the train step keeps each rank's shard)."""
    _, _, w2, _ = runs
    for out in w2:
        gaps = out["errors"]["moe_grads"]
        assert set(gaps) >= {"x", "router", "wg", "wu", "wd"}
        assert max(gaps.values()) < 1e-2, gaps
        assert out["errors"]["moe_grads_other_experts"] == 0.0


@pytest.mark.parametrize("world", list(SHARD_MESHES))
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_local_shards_equal_the_reference_devices(world, arch, runs):
    """``params_from_reference(..., mesh=)``: every rank's local shard of
    every parameter equals the reference's shard on the device at the
    same mesh coordinates, on (data 2, model 2) and on (pod 2, data 1,
    model 2) with FSDP over ("pod", "data")."""
    _, _, _, w4 = runs
    for r, out in enumerate(w4):
        rec = out["errors"][f"shards/{world}/{arch}"]
        assert rec["n"] > 0 and rec["bad"] == [], (r, rec["bad"][:5])


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_on_a_mesh_matches_reference(arch, runs):
    """Every family's smoke-config ``loss`` on a (2, 2) mesh, the global
    batch's mean, within TOL relative of the reference's on its mesh."""
    ref, _, _, w4 = runs
    want = float(ref[f"loss/{arch}"])
    for out in w4:
        assert abs(float(out[f"loss/{arch}"]) - want) <= TOL * abs(want)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_on_a_mesh_match_reference(arch, runs):
    """``prefill`` of 4 x 16 tokens and two ``decode_step``s on its cache
    (copied into a 24-position one) on a (2, 2) mesh: the global logits
    within TOL of the reference's max."""
    ref, _, _, w4 = runs
    for key in ["prefill"] + [f"decode{t}" for t in range(DECODE_STEPS)]:
        for out in w4:
            assert _rel(ref[f"serve/{arch}/{key}"],
                        out[f"serve/{arch}/{key}"]) < TOL, key


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_a_mesh_matches_reference(arch, runs):
    """One train step on a (2, 2) mesh from the reference's initial
    state: loss and gnorm within ``tests/test_torch_train_step.py``'s
    tolerances, the first moments within GRAD_TOL of each leaf's max,
    the gathered f32 masters within 1e-6 where the gradient is clear
    and within 2 x LR elsewhere; each rank holds a quarter to a half of
    the masters (replicated gains and unsplittable dims).

    A routed model's gradients are discontinuous (ROADMAP C11): at 32
    tokens a DP shard its capacity cut moves a token between experts
    at a near-tie, and the reference's own step, compiled with excess
    precision on, moves its first moments by up to 36 % of a leaf's max
    (``self_gap``, measured in the reference subprocess).  There the
    moments are held within that spread and the masters within one
    step (2 x LR) everywhere; the loss and gnorm as above."""
    from repro_torch.configs import smoke_config
    from repro_torch.convert import _model, reference_leaves
    ref, _, _, w4 = runs
    cfg = smoke_config(arch).scaled(vocab=VOCAB)
    out = w4[0]
    tol = ROUTED_TOL if arch in ROUTED else LOSS_RTOL
    want_loss = float(ref[f"train/{arch}/loss"])
    assert abs(float(out[f"train/{arch}/loss"]) - want_loss) \
        <= tol * abs(want_loss)
    want_g = float(ref[f"train/{arch}/gnorm"])
    assert abs(float(out[f"train/{arch}/gnorm"]) - want_g) \
        <= GNORM_RTOL * want_g
    names = _model(cfg, "meta")
    want_p = {n: a for n, _, a in reference_leaves(
        cfg, names, nest(ref, f"train/{arch}/new"))}
    want_m = {n: a for n, _, a in reference_leaves(
        cfg, names, nest(ref, f"train/{arch}/m"))}
    routed = arch in ROUTED
    m_tol = max(GRAD_TOL, float(ref[f"train/{arch}/self_gap"])) if routed \
        else GRAD_TOL
    for name, wp in want_p.items():
        wm, got_m = want_m[name], out[f"train/{arch}/m/{name}"]
        top = np.abs(wm).max()
        if top:
            assert np.abs(got_m - wm).max() <= m_tol * top, name
        clear = (np.abs(wm) > GRAD_TOL * top) & (np.abs(wm) > 1e-5)
        gap = np.abs(out[f"train/{arch}/new/{name}"] - wp)
        if not routed:
            assert gap[clear].max(initial=0) <= 1e-6, name
        assert gap.max() <= 2 * LR + 1e-6, name
    for other in w4[1:]:
        np.testing.assert_array_equal(other[f"train/{arch}/loss"],
                                      out[f"train/{arch}/loss"])
    held, total = out["errors"][f"train/{arch}/held"]
    assert total / 4 <= held <= total / 2, (held, total)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_checkpoint_restores_across_meshes(arch, runs):
    """The stepped state saved on (2, 2) (rank 0 writes whole arrays) and
    restored on (4, 1) and on one rank without a mesh: masters and
    moments bit-equal to the state that was saved."""
    _, _, _, w4 = runs
    for out in w4:
        step, bad_p, bad_m = out["errors"][f"train/{arch}/restored_4x1"]
        assert step == 1 and bad_p == [] and bad_m == []
    step, bad = w4[0]["errors"][f"train/{arch}/restored_one"]
    assert step == 1 and bad == []


@pytest.mark.parametrize("case", list(LC_CASES))
@pytest.mark.parametrize("arch", LC_ARCHS)
def test_long_context_decode_matches_reference(arch, case, runs):
    """A9 (e): a batch the DP ranks do not divide (1 on (4, 1), 3 on (2,
    2)), its cache split on the sequence axis by ``cache_specs``: the
    prefill of 16 positions and ``DECODE_STEPS`` decode steps on a
    24-position cache grown from it, every rank's global logits within
    TOL of the reference's max (its jitted steps on a cache placed by
    its ``cache_specs``), the K/V split on the sequence axis over
    "data"."""
    ref, _, _, w4 = runs
    key = f"lc/{arch}/{case}"
    for out in w4:
        for step in ["prefill"] + [f"decode{t}" for t in
                                   range(DECODE_STEPS)]:
            assert _rel(ref[f"{key}/{step}"], out[f"{key}/{step}"]) < TOL, \
                step
        for path, kinds in out["errors"][f"{key}/placements"].items():
            if not path.startswith("cross"):
                assert kinds[0] == ["shard", 2], (path, kinds)


@pytest.mark.parametrize("case", list(LC_CASES))
@pytest.mark.parametrize("arch", LC_ARCHS)
def test_long_context_cache_shards_equal_the_reference_devices(arch, case,
                                                               runs):
    """After the decode steps, each rank's local K/V (or latent) cache
    equals the reference's shard on the device at its mesh coordinates
    within TOL of the leaf's max: the same positions on the same rank,
    the new tokens' rows written by the rank that holds them."""
    ref, _, _, w4 = runs
    key = f"lc/{arch}/{case}"
    for r, out in enumerate(w4):
        paths = list(out["errors"][f"{key}/placements"])
        assert paths
        for path in paths:
            want = ref[f"{key}/shard/{r}/{path}"]
            got = out[f"{key}/shard/{r}/{path}"]
            assert _rel(want, got) < TOL, (r, path)


def test_long_context_ssm_state_replicates(runs):
    """mamba2-130m at batch 1 on (4, 1): its state has no sequence axis,
    so it replicates; the logits match the reference's."""
    ref, _, _, w4 = runs
    key = f"lc/{LC_SSM}/4x1"
    for out in w4:
        for step in ["prefill"] + [f"decode{t}" for t in
                                   range(DECODE_STEPS)]:
            assert _rel(ref[f"{key}/{step}"], out[f"{key}/{step}"]) < TOL
        for kinds in out["errors"][f"{key}/state"]:
            assert kinds == [["replicate"], ["replicate"]], kinds


def test_long_context_step_past_the_cache_drops_its_write(runs):
    """``past_cache="drop"`` at ``cur_len`` SMAX + 2 on the
    sequence-sharded cache: no rank writes, every rank attends over all
    of its positions (C8), as the reference's out-of-range scatter."""
    ref, _, _, w4 = runs
    key = f"lc/{DROP_ARCH}/4x1"
    for out in w4:
        assert _rel(ref[f"{key}/drop"], out[f"{key}/drop"]) < TOL
        assert _rel(ref[f"{key}/drop_cache"], out[f"{key}/drop_cache"]) \
            < TOL


@pytest.mark.parametrize("arch", LC_ARCHS)
def test_long_context_exchange_does_not_grow_with_the_cache(arch, runs):
    """No fallback gathers the cache: a decode step's collective bytes by
    kind (the weights' all-gathers, the attention's all-reduces of its
    softmax terms, the only all-reduces of a step at batch 1) are the
    same at SMAX 24 and 96, and the attention's are nonzero."""
    _, _, _, w4 = runs
    for out in w4:
        small, wide = out["errors"][f"lc/{arch}/4x1/exchange"]
        assert small == wide, (small, wide)
        assert small["all-reduce"] > 0


def test_long_context_ok_at_a_length_dp_does_not_divide(runs):
    """At 7 positions, which dp 2 does not divide, the cache of a batch
    of 1 replicates, as ``cache_specs`` places it."""
    _, _, _, w4 = runs
    for out in w4:
        refused, kinds = out["errors"]["long_context_ok"]
        assert refused == ["", ""]
        assert kinds == [["replicate"], ["replicate"]]


@pytest.mark.parametrize("slices", [1, 2, 3, 4])
def test_combine_merges_slices_into_one_softmax(slices):
    """``placement.merge_softmax`` over random scores split into
    ``slices`` pieces (one fully masked when there are several) equals
    the one-piece softmax-weighted sum within 1e-6, with no NaN."""
    import torch
    from repro_torch.models import placement as P
    gen = torch.Generator().manual_seed(slices)
    n, d = 24, 8
    s = torch.randn(3, 4, n, generator=gen, dtype=torch.float64) * 4
    v = torch.randn(3, n, d, generator=gen, dtype=torch.float64)
    valid = torch.ones(3, 4, n, dtype=torch.bool)
    if slices > 1:
        valid[..., n // slices:2 * n // slices] = False   # a masked slice
    want = torch.einsum("bhs,bsd->bhd", torch.softmax(
        torch.where(valid, s, -torch.inf), -1), v)

    def pieces(x, dim):
        return torch.stack(x.chunk(slices, dim))         # slices first
    vs = pieces(v, 1)

    def reduce(x, op):
        return x.amax(0, keepdim=True) if op == "max" \
            else x.sum(0, keepdim=True)

    got = P.merge_softmax(pieces(s, -1), pieces(valid, -1),
                          lambda p: torch.einsum("kbhs,kbsd->kbhd", p, vs),
                          reduce)[0]
    assert not torch.isnan(got).any()
    assert float((got - want).abs().max()) < 1e-6


def test_attention_outputs_read_each_attention_and_plant_the_fault():
    """``testing.long_context.attention_outputs`` reads a whole cache's
    decode attention in f32 (its bf16 cast is the call's output) and a
    merge's result; with ``zero_terms`` the merge's sums get zeros from
    this rank and its max its own value."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import placement as P
    from repro_torch.testing.long_context import attention_outputs
    gen = torch.Generator().manual_seed(3)
    B, S, H, Hkv, hd = 2, 12, 4, 2, 8
    q = torch.randn(B, 1, H, hd, generator=gen).to(torch.bfloat16)
    k, v = (torch.randn(B, S, Hkv, hd, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    with attention_outputs() as rec:
        out = L.decode_attention(q, k, v, 9)
    assert len(rec) == 1 and rec[0].dtype == torch.float32
    assert torch.equal(rec[0].reshape(out.shape).to(out.dtype), out)

    s = torch.randn(B, H, S, generator=gen)
    valid = torch.ones(B, H, S, dtype=torch.bool)
    vals = torch.randn(B, S, hd, generator=gen)
    seen = []

    def reduce(x, op):
        seen.append((op, x.clone()))
        return x

    def mix(p):
        return torch.einsum("bhs,bsd->bhd", p, vals)

    with attention_outputs() as rec:
        got = P.merge_softmax(s, valid, mix, reduce)
    assert len(rec) == 1 and torch.equal(rec[0], got)
    seen.clear()
    with attention_outputs(zero_terms=True):
        P.merge_softmax(s, valid, mix, reduce)
    assert [op for op, _ in seen] == ["max", "sum", "sum"]
    assert torch.equal(seen[0][1], s.amax(-1))
    assert all(not x.any() for op, x in seen if op == "sum")
    # both hooks are taken out again
    assert P.merge_softmax.__name__ == "merge_softmax"
    assert L.grouped_mix.__name__ == "grouped_mix"


def test_constrainer_pins_rows_over_data(runs):
    """``make_constrainer`` redistributes a DTensor to ``Shard(0)`` over
    "data" (replicated over "model"), keeping its values, and leaves a
    batch that does not divide as it is."""
    _, _, _, w4 = runs
    placements, same, odd = w4[0]["errors"]["constrain"]
    assert placements == [["shard", 0], ["replicate"]] and same
    assert odd == [["replicate"], ["replicate"]]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_load_neither_jax_nor_the_reference(world, runs):
    _, _, w2, w4 = runs
    for out in (w2 if world == 2 else w4):
        assert out["errors"]["foreign"] == []


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
