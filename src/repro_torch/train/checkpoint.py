"""Checkpointing: async, atomic, restorable onto another device.

Counterpart of the reference package's ``train/checkpoint.py``.  Arrays
are saved unsharded, so a checkpoint restores onto any mesh.

Layout: <dir>/step_<n>/{manifest.json, <idx>.npy ...}; a checkpoint is
valid iff its ``manifest.json`` exists (written LAST, after every tensor,
then the directory renamed from ``step_<n>.tmp``): the atomicity marker
that makes interrupted saves harmless.

* A tree is flattened in a fixed order: a dataclass's fields, a dict's
  keys sorted, a list's items; a bf16 tensor is saved as its int16 bits
  (numpy has no bf16) and read back as bf16.
* ``save_async`` copies to host memory synchronously (the device-to-host
  copy waits for the device) and writes on a daemon thread: the train
  loop blocks only for the copy.
* On a mesh every rank calls ``save``: each placed leaf (``DTensor``) is
  gathered whole, rank 0 alone writes, and the others wait for it (a
  barrier), so no rank ever writes a partial leaf.
* ``restore`` loads the newest valid step into the template's structure,
  dtypes and devices, onto one target device, or onto a mesh: each leaf
  into its ``configs.sharding.Placed`` placement (``shardings``, a tree
  of the template's structure, None leaves as the template's).
* GC: ``keep_last`` bounds disk usage.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.sharding import Placed
from repro_torch.models import placement as P


def _flatten(tree) -> list:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _flatten(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in ``_flatten``'s order."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = P.full(x.detach(), device="cpu")
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    return np.asarray(x)


def _placed_tree(leaves) -> bool:
    """Whether a tree's leaves live on a mesh (every rank saves it)."""
    return any(P.is_placed(x) for x in leaves)


def save(tree, directory: str, step: int, *, keep_last: int = 3):
    """Write ``tree`` as step ``step``; on a mesh every rank calls it, rank
    0 writes and the others wait until it has."""
    leaves = _flatten(tree)
    host = [_to_host(x) for x in leaves]
    if not _placed_tree(leaves):
        _write(host, directory, step, keep_last)
        return
    if dist.get_rank() == 0:
        _write(host, directory, step, keep_last)
    dist.barrier()


_PENDING: list = []


def save_async(tree, directory: str, step: int, *, keep_last: int = 3):
    """Device-to-host copy synchronously, disk write on a thread; a tree on
    a mesh is saved synchronously (``save``) and None returned."""
    leaves = _flatten(tree)
    if _placed_tree(leaves):
        save(tree, directory, step, keep_last=keep_last)
        return None
    host = [_to_host(x) for x in leaves]
    t = threading.Thread(target=_write, args=(host, directory, step,
                                              keep_last), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    while _PENDING:
        _PENDING.pop().join()


def _write(host_leaves, directory, step, keep_last):
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    for i, arr in enumerate(host_leaves):
        np.save(os.path.join(tmp, f"{i}.npy"), arr)
    meta = {"step": step, "n_leaves": len(host_leaves)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # GC old checkpoints
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def latest_steps(directory):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name[5:]))
    return out


def _like(arr: np.ndarray, leaf, target):
    """``arr`` as ``leaf`` is held: a tensor of its dtype on ``target`` (a
    device; its own device by default), or placed by ``target`` (a
    ``Placed``), or a numpy array of its dtype."""
    if not torch.is_tensor(leaf):
        return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr
    t = torch.from_numpy(arr)
    if leaf.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    if target is None and P.is_placed(leaf):
        target = Placed(leaf.device_mesh, P.spec_of(leaf))
    if isinstance(target, Placed):
        return P.place(t.to(device=P.mesh_device(target.mesh),
                            dtype=leaf.dtype), target.mesh, target.spec)
    return t.to(device=P.local(leaf).device if target is None else target,
                dtype=leaf.dtype)


def restore(template, directory: str, *, shardings=None,
            step: int | None = None):
    """Restore the newest (or the given) step into ``template``'s
    structure: (tree, step), or (None, -1) without a valid checkpoint.
    ``shardings``: None (each leaf on its template leaf's device), a
    target device for every leaf, or a tree of the template's structure
    whose leaves are ``Placed`` (the leaf restored into that placement on
    its mesh, as ``train_step.state_shardings`` gives) or None (as the
    template's leaf): the elastic path, onto any mesh."""
    leaves = _flatten(template)
    if shardings is None or isinstance(shardings, (str, torch.device)):
        targets = [None if shardings is None else torch.device(shardings)
                   ] * len(leaves)
    else:
        targets = _flatten(shardings)
        if len(targets) != len(leaves):
            raise ValueError(f"shardings has {len(targets)} leaves, the "
                             f"template {len(leaves)}")
    steps = latest_steps(directory)
    if not steps:
        return None, -1
    step = max(steps) if step is None else step
    d = os.path.join(directory, f"step_{step:010d}")
    host = [np.load(os.path.join(d, f"{i}.npy")) for i in range(len(leaves))]
    return _unflatten(template, iter(
        _like(h, leaf, target)
        for h, leaf, target in zip(host, leaves, targets))), step
