"""Checkpointing: async, atomic, restorable onto another device.

Counterpart of the reference package's ``train/checkpoint.py``.

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
* ``restore`` loads the newest valid step into the template's structure,
  dtypes and devices, or onto one target device (``shardings``); a mesh
  placement is ROADMAP A9 (d).
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
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.cpu().numpy()
    return np.asarray(x)


def save(tree, directory: str, step: int, *, keep_last: int = 3):
    _write([_to_host(x) for x in _flatten(tree)], directory, step, keep_last)


_PENDING: list = []


def save_async(tree, directory: str, step: int, *, keep_last: int = 3):
    """Device-to-host copy synchronously, disk write on a thread."""
    host = [_to_host(x) for x in _flatten(tree)]
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


def _like(arr: np.ndarray, leaf, device):
    """``arr`` as ``leaf`` is held: a tensor of its dtype on ``device``
    (its own device by default), or a numpy array of its dtype."""
    if not torch.is_tensor(leaf):
        return arr.astype(leaf.dtype) if hasattr(leaf, "dtype") else arr
    t = torch.from_numpy(arr)
    if leaf.dtype == torch.bfloat16 and t.dtype == torch.int16:
        t = t.view(torch.bfloat16)
    return t.to(device=leaf.device if device is None else device,
                dtype=leaf.dtype)


def restore(template, directory: str, *, shardings=None,
            step: int | None = None):
    """Restore the newest (or the given) step into ``template``'s
    structure: (tree, step), or (None, -1) without a valid checkpoint.
    ``shardings``: None (each leaf on its template leaf's device) or a
    target device for every leaf; a mesh placement is not ported yet
    (ROADMAP A9 (d))."""
    if shardings is not None and not isinstance(shardings,
                                                (str, torch.device)):
        raise NotImplementedError(
            "restoring onto a mesh is not ported yet (ROADMAP A9 (d)): "
            "pass a device")
    device = None if shardings is None else torch.device(shardings)
    steps = latest_steps(directory)
    if not steps:
        return None, -1
    step = max(steps) if step is None else step
    d = os.path.join(directory, f"step_{step:010d}")
    leaves = _flatten(template)
    host = [np.load(os.path.join(d, f"{i}.npy")) for i in range(len(leaves))]
    return _unflatten(template, iter(
        _like(h, leaf, device) for h, leaf in zip(host, leaves))), step
