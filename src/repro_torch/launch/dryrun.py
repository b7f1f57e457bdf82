"""Multi-pod dry run: count every (arch x shape x mesh) cell's step.

The port's counterpart of the reference package's ``launch/dryrun.py``.
The reference lowers and compiles each cell against its production mesh
on 512 fake CPU devices and reads the compiled HLO.  Here each cell is
built on the ``meta`` device (shapes only, nothing allocated) under a
fake process group of the production mesh's size (256 ranks, 512 for
``multipod``; ``torch.testing._internal.distributed.fake_pg``, whose
collectives do nothing), as rank 0 of it: the model's parameters placed
by ``param_specs``, the batch or cache by ``batch_specs`` and
``cache_specs``, and the step run once under ``launch.hlo_cost``'s
``CostCounter``.  The counts are that rank's; ``roofline.analyze`` turns
them into terms at the H100's peaks.  What stands in for the HLO is the
per-op count table, saved as gzip-compressed JSON beside each record
(``launch.reanalyze`` reads it back).

A cell that cannot run on meta tensors (a host read of a tensor's value,
a shape that depends on data) records ``ok: false`` with its error, as
the reference's ``run_cell`` records a failed lowering.  The retrieval
cell counts the torch engine's plain path: a CUDA kernel cannot run on
meta tensors.

Usage:
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun_torch
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, SHAPES, applicable_shapes, get_arch
from repro_torch.launch import hlo_cost as HC
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import dp_axes as mesh_dp_axes
from repro_torch.launch.mesh import make_production_mesh

DEVICE = torch.device("meta")


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block; the group is destroyed after it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(tree) -> int:
    from repro_torch.models import placement as P
    from torch.utils._pytree import tree_leaves
    return sum(P.local(t).numel() * P.local(t).element_size()
               for t in tree_leaves(tree) if torch.is_tensor(t))


def _batch(cfg, shape):
    """The global batch as meta tensors (every rank is given it whole)."""
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=DEVICE)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.empty((B, min(S, 1024), cfg.d_model),
                                          device=DEVICE)
    if cfg.family == "vlm" and cfg.prefix_len:
        batch["patches"] = torch.empty((B, cfg.prefix_len, cfg.d_model),
                                       device=DEVICE)
    return batch


def lower_cell(arch: str, shape_name: str, mesh, *,
               moment_dtype=torch.float32, remat="block", pad_heads=False,
               attn_blocks=None, retrieval_overrides=None):
    """Returns (run, chips, model_flops, state_bytes): ``run()`` runs the
    cell's step once on this rank's meta tensors; ``state_bytes`` is the
    placed state this rank holds.  The port's FSDP dims are its DP dims
    (``build_model(dp_axes=)``), so the reference's ``fsdp=`` (its
    ``--fsdp-data-only``) has no counterpart."""
    from repro_torch.models import build_model
    dp = mesh_dp_axes(mesh)
    chips = int(np.prod(tuple(mesh.shape)))

    if arch == "dco-retrieval":
        return _lower_retrieval(shape_name, mesh, chips,
                                overrides=retrieval_overrides)

    cfg = get_arch(arch)
    if attn_blocks:
        cfg = dataclasses.replace(cfg, attn_block_q=attn_blocks[0],
                                  attn_block_kv=attn_blocks[1])
    if pad_heads and cfg.n_heads:
        # Megatron-style: pad query heads to a TP-divisible count
        tp = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))["model"]
        if cfg.n_heads % tp:
            cfg = dataclasses.replace(
                cfg, n_heads=((cfg.n_heads + tp - 1) // tp) * tp)
    shape = SHAPES[shape_name]
    api = build_model(cfg, mesh=mesh, dp_axes=dp, remat=remat,
                      device=DEVICE)
    mf = RL.model_flops_estimate(cfg, shape)

    if shape.kind == "train":
        from repro_torch.train.train_step import init_state, make_train_step
        state = init_state(api, None, moment_dtype=moment_dtype)
        step = make_train_step(api)
        batch = _batch(cfg, shape)
        return (lambda: step(state, batch)), chips, mf, _local_bytes(
            (state.params, state.opt))

    params = api.init(None)
    if shape.kind == "prefill":
        batch = _batch(cfg, shape)
        return _serving(api.prefill, params, batch), chips, mf, \
            _local_bytes(list(params.parameters()))

    B, S = shape.global_batch, shape.seq_len
    cache = api.init_cache(B, S)
    token = torch.empty((B,), dtype=torch.int32, device=DEVICE)
    cur_len = torch.empty((B,), dtype=torch.int32, device=DEVICE)
    return _serving(api.decode_step, params, cache, token, cur_len), chips, \
        mf, _local_bytes((list(params.parameters()), cache))


def _serving(fn, *args):
    """``fn(*args)`` as a thunk run without autograd (a serving step)."""
    def run():
        with torch.no_grad():
            return fn(*args)
    return run


def _lower_retrieval(shape_name, mesh, chips, overrides=None):
    from repro_torch.configs.dco_bench import CONFIG as rc
    from repro_torch.core.torch_engine import (DcoEngineConfig,
                                               make_distributed_topk)
    ov = overrides or {}
    axes = tuple(mesh.mesh_dim_names)
    n_per = (rc.n_total + chips - 1) // chips
    cfg = DcoEngineConfig(kind=rc.kind, d1=ov.get("d1", rc.d1), k=rc.k,
                          capacity=ov.get("capacity", rc.capacity),
                          query_chunk=ov.get("query_chunk", 8))
    fn = make_distributed_topk(mesh, cfg, shard_axes=axes,
                               engine="two_stage")
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    sdt = dt[ov.get("stage1_dtype", "float32")]
    tdt = dt[ov.get("tail_dtype", "float32")]

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=DEVICE)
    state = {"x_lead": empty((n_per, cfg.d1), sdt),
             "x_tail": empty((n_per, rc.dim - cfg.d1), tdt),
             "lead_sq": empty((n_per,)), "tail_sq": empty((n_per,))}
    q_lead = empty((rc.query_batch, cfg.d1), sdt)
    q_tail = empty((rc.query_batch, rc.dim - cfg.d1), tdt)
    # model "flops": stage-1 exact cost (the useful work of the scan)
    mf = 2.0 * rc.query_batch * rc.n_total * cfg.d1
    return _serving(fn, state, q_lead, q_tail, {}), chips, mf, \
        _local_bytes(state)


def run_cell(arch, shape_name, mesh_kind, out_dir, tag="", mesh=None, **kw):
    """Count one cell (on ``mesh``, or the production mesh of
    ``mesh_kind`` under its own fake group) and write its record, and its
    count table under ``out_dir/counts``; returns the record."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "options": str(kw)}
    sfx = f"__{tag}" if tag else ""
    world = 512 if mesh_kind == "multipod" else 256
    group = fake_group(world) if mesh is None else contextlib.nullcontext()
    with group:
        try:
            if mesh is None:
                mesh = make_production_mesh(multi_pod=mesh_kind == "multipod",
                                            device_type="meta")
            rec["mesh_shape"] = dict(zip(mesh.mesh_dim_names,
                                         tuple(mesh.shape)))
            run, chips, mf, state_bytes = lower_cell(arch, shape_name, mesh,
                                                     **kw)
            t1 = time.time()
            with HC.CostCounter() as c:
                run()
            t2 = time.time()
            table = c.table()
            rec.update(RL.analyze(table, chips=chips, model_flops=mf,
                                  memory=RL.memory(DEVICE, state_bytes)))
            rec.update({"lower_s": t1 - t0, "count_s": t2 - t1, "ok": True})
            os.makedirs(os.path.join(out_dir, "counts"), exist_ok=True)
            HC.save_table(table, _table_path(out_dir, rec, sfx))
        except Exception as e:
            rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:]})
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{mesh_kind}__{arch}__{shape_name}{sfx}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = "OK" if rec.get("ok") else "FAIL"
    dom = rec.get("dominant", "-")
    print(f"[{status}] {mesh_kind:8s} {arch:22s} {shape_name:12s} "
          f"dominant={dom} t={time.time()-t0:.1f}s", flush=True)
    return rec


def _table_path(out_dir, rec, sfx) -> str:
    return os.path.join(out_dir, "counts", f"{rec['mesh']}__{rec['arch']}__"
                        f"{rec['shape']}{sfx}.json.gz")


def all_cells():
    cells = []
    for arch in ARCH_NAMES:
        cfg = get_arch(arch)
        for s in applicable_shapes(cfg):
            cells.append((arch, s))
    cells.append(("dco-retrieval", "serve"))
    return cells


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--moment-bf16", action="store_true")
    ap.add_argument("--attn-blocks", default="",
                    help="block_q,block_kv override for blockwise attention")
    ap.add_argument("--retr", default="",
                    help="retrieval overrides k=v,... (stage1_dtype, tail_dtype, d1, capacity)")
    ap.add_argument("--tag", default="", help="suffix for artifact filenames")
    args = ap.parse_args()
    if args.list:
        for a, s in all_cells():
            print(a, s)
        return
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    kw = {}
    if args.pad_heads:
        kw["pad_heads"] = True
    if args.moment_bf16:
        kw["moment_dtype"] = torch.bfloat16
    if args.attn_blocks:
        kw["attn_blocks"] = tuple(int(x) for x in args.attn_blocks.split(","))
    if args.retr:
        ov = {}
        for kv2 in args.retr.split(","):
            k2, v2 = kv2.split("=")
            ov[k2] = int(v2) if v2.isdigit() else v2
        kw["retrieval_overrides"] = ov
    for mk in meshes:
        for arch, shape in cells:
            run_cell(arch, shape, mk, args.out, tag=args.tag, **kw)


if __name__ == "__main__":
    main()
