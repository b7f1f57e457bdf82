"""Start the ranks of a mesh as local processes, and join their group.

A mesh session runs one process a rank.  :func:`run_ranks` starts
``world`` copies of one command, each told its rank, the world size and
a file rendezvous (``file://`` in a directory of the caller's, so no TCP
port is needed and several launches can run side by side); a rank calls
:func:`join` to initialise its process group from them.  The launcher
waits on the ranks with a deadline of its own: past it, or as soon as
one rank fails, it kills the others (which would otherwise wait in a
collective) and raises.

    outs = run_ranks([sys.executable, "worker.py"], 2, workdir=tmp,
                     timeout_s=120)
    # worker.py:
    rank, world = join("gloo")
    mesh = make_host_mesh(world, 1, device_type="cpu")
"""
from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import GROUP_TIMEOUT

_RANK, _WORLD, _INIT = "MESH_RANK", "MESH_WORLD", "MESH_INIT"


def join(backend: str) -> tuple[int, int]:
    """Initialise this rank's process group (``backend`` "gloo" or
    "nccl") from the variables :func:`run_ranks` set; returns (rank,
    world).  Torch's intra-op threads are set to one: the ranks share
    the host's cores."""
    rank, world = int(os.environ[_RANK]), int(os.environ[_WORLD])
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=os.environ[_INIT],
                            rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    return rank, world


def run_ranks(argv: list, world: int, *, workdir, timeout_s: float,
              env: dict | None = None, cwd=None) -> list[str]:
    """Run ``argv`` as ``world`` ranks and return each rank's standard
    output.  ``workdir`` (a directory of the caller's) holds the
    rendezvous file and the ranks' logs.  Raises ``TimeoutError`` past
    ``timeout_s`` and ``RuntimeError`` when a rank exits nonzero, after
    killing every rank still running."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    init = workdir / "rendezvous"
    if init.exists():
        init.unlink()
    base = dict(os.environ if env is None else env)
    procs, logs = [], []
    try:
        for r in range(world):
            out = open(workdir / f"rank{r}.out", "w+")
            err = open(workdir / f"rank{r}.err", "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                argv, cwd=cwd, stdout=out, stderr=err,
                env=dict(base, **{_RANK: str(r), _WORLD: str(world),
                                  _INIT: f"file://{init}"})))
        deadline = time.monotonic() + timeout_s
        while True:
            done = all(p.poll() is not None for p in procs)
            bad = [r for r, p in enumerate(procs) if p.poll()]
            if bad:
                raise RuntimeError(
                    f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                    + _tails(logs))
            if done:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout_s} s" + _tails(logs))
            time.sleep(0.05)
        outs = []
        for out, _ in logs:
            out.seek(0)
            outs.append(out.read())
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def _tails(logs, n: int = 3000) -> str:
    """The end of every rank's standard error."""
    out = []
    for r, (_, err) in enumerate(logs):
        err.flush()
        err.seek(0)
        out.append(f"\n--- rank {r} stderr ---\n" + err.read()[-n:])
    return "".join(out)
