"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  No ninja and no
PyTorch headers are involved, so a cold build takes seconds.  The library
lives under ``build/torch_ext/`` at the root of the checkout, named by a
hash of the sources, the headers beside them (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds on first use.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from repro_torch.utils import trace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
CFLAGS = ["-O3", ARCH, "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
#: ptxas register / shared-memory report of the last build (empty when the
#: library was already on disk)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library_path(sources) -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in sorted([*sources, *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(sources, out: Path) -> str:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *CFLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)        # atomic: a reader never sees half
    return "\n".join(logs)


def _bind(lib):
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.dco_scan_launch, lib.dco_scan_tiled_launch,
               lib.dco_scan_grouped_launch,
               lib.dco_scan_grouped_tiled_launch):
        fn.argtypes = [vp] * 10 + [i32] * 5 + [vp]
        fn.restype = i32
    lib.dco_scan_fill_free.argtypes = [i32]
    lib.dco_scan_fill_free.restype = i32
    lib.dco_scan_max_active_clusters.argtypes = [i32, i32]
    lib.dco_scan_max_active_clusters.restype = i32
    for fn in (lib.pq_lookup_u8_launch, lib.pq_lookup_i32_launch,
               lib.pq_lookup_staged_launch):
        fn.argtypes = [vp] * 3 + [i32] * 5 + [vp]
        fn.restype = i32
    lib.repro_cuda_error_string.argtypes = [i32]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """The loaded kernel library, built from ``csrc/`` on first use (the
    set-up span ``kernels.build``: the build, or the load of a library
    already on disk)."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            sources = sorted(CSRC.glob("*.cu"))
            path = _library_path(sources)
            with trace.setup_span("kernels.build",
                                  compiled=not path.exists()):
                if not path.exists():
                    build_log = _compile(sources, path)
                _lib = _bind(ctypes.CDLL(str(path)))
        return _lib


def check(lib, err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({err}: {msg})")
