"""Builds and loads the hand-written CUDA kernels of ``repro_torch/csrc``.

At first use, ``load()`` compiles every ``csrc/*.cu`` with ``nvcc`` (one
process per source, all started together) for ``sm_90a`` into a shared
library with a plain C interface, and loads it with ``ctypes``.  The
library lands in ``build/repro_torch_kernels/`` at the repository root,
named by a hash of the sources and flags, so an unchanged tree reuses it
and a changed one rebuilds.  Nothing is fetched; the build needs only the
CUDA toolkit's ``nvcc``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
#: C entry points and their argument types (pointers and the stream as void*)
_SIGNATURES = {
    "repro_reduce_blocks": [_I64],
    "repro_max_width": [],
    "repro_max_depth": [],
    "repro_multidot_f32": [_P, _I64, _P, _I64, _I64, _INT, _P, _P, _P],
    "repro_multidot_f64": [_P, _I64, _P, _I64, _I64, _INT, _P, _P, _P],
    "repro_window_axpy_f32": [_P, _I64, _P, _I64, _P, _I64, _INT, _P, _P],
    "repro_window_axpy_f64": [_P, _I64, _P, _I64, _P, _I64, _INT, _P, _P],
    "repro_fused_body_f32": [_P, _P, _P, _P, _I64, _INT, _I64, _I64, _P, _P, _P, _P, _P],
    "repro_fused_body_f64": [_P, _P, _P, _P, _I64, _INT, _I64, _I64, _P, _P, _P, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    """The loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: pathlib.Path
    cache_hit: bool
    build_seconds: float
    log: str              # nvcc/ptxas output of the build ("" on a cache hit)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin); "
                           "the CUDA kernels are built from source at first use")
    return found


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(so_path: pathlib.Path) -> str:
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                for other in procs:
                    other.kill()
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_so = pathlib.Path(tmp) / so_path.name
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp_so),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_so, so_path)
    return "\n".join(logs)


@functools.cache
def load() -> KernelLibrary:
    """Build (if needed) and load the kernel library; cached per process."""
    so_path = BUILD_DIR / f"repro_torch_kernels_{_source_key()}.so"
    t0 = time.perf_counter()
    cache_hit = so_path.exists()
    log = "" if cache_hit else _compile(so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=so_path, cache_hit=cache_hit,
                         build_seconds=time.perf_counter() - t0, log=log)
