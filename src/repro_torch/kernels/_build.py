"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/kernels/lib<name>-<hash>
.so`` at the root of the checkout, the first time it is needed; the
content hash in the file name means an edited source is never served a
stale library.  The library is loaded with ``ctypes``: pointers and the
CUDA stream travel as ``c_void_p``, and every C entry returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
:func:`build_all` starts one ``nvcc`` per source at once (the sources
are independent), which is how ``chip_smoke.py`` keeps its build short.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# per-source extra flags: the scans must not contract a*b+c into FMAs,
# or their rounding (and therefore a cut placed near beta) moves
EXTRA_FLAGS = {"pricing": ("-fmad=false",), "dlv_scan": ("-fmad=false",)}
SOURCES = ("pricing", "bfrt", "segstats", "dlv_scan")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    flags = " ".join(BASE_FLAGS + EXTRA_FLAGS.get(name, ()))
    h = hashlib.sha1(src.read_bytes() + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *BASE_FLAGS, *EXTRA_FLAGS.get(name, ()),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)          # atomic: concurrent builds never race


def build_all() -> float:
    """Compile every source in parallel; returns the wall seconds spent.
    Already-built libraries are not rebuilt."""
    t0 = time.perf_counter()
    with _LOCK:
        jobs = {nm: _start(nm) for nm in SOURCES}
        for nm, job in jobs.items():
            _finish(nm, job)
    return time.perf_counter() - t0


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes``/``restype`` set from ``signatures`` (entry -> argtypes)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


P = ctypes.c_void_p
I64 = ctypes.c_int64
F64 = ctypes.c_double
