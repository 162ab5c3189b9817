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
# or their rounding (and therefore a cut placed near beta) moves, nor
# segment stats, or its torch mirror could not match it bit for bit, nor
# the batched LP engine, whose BFRT running sum rounds as numpy's does;
# flash, the scan, segment stats, the BFRT select and the split-tree
# descent keep ptxas's report of registers, shared memory and spills
# (build_log)
EXTRA_FLAGS = {"pricing": ("-fmad=false",),
               "lp_batch": ("-fmad=false", "-Xptxas", "-v"),
               "bfrt": ("-Xptxas", "-v"),
               "segstats": ("-fmad=false", "-Xptxas", "-v"),
               "dlv_scan": ("-fmad=false", "-Xptxas", "-v"),
               "flash_attn": ("-Xptxas", "-v"),
               "flash_attn_bwd": ("-Xptxas", "-v"),
               "split_tree": ("-Xptxas", "-v")}
# split_tree_bisect: the descent kernel that split_tree replaced, built
# only as the baseline it is timed against
SOURCES = ("pricing", "bfrt", "segstats", "dlv_scan", "flash_attn",
           "flash_attn_bwd", "lp_batch", "split_tree", "split_tree_bisect")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# each source's nvcc wall seconds, for the sources built in this process
BUILD_SECONDS: Dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); "
                           "the CUDA kernels cannot be built")
    return path


def lib_path(name: str, defines: tuple = ()) -> Path:
    """The library of ``csrc/<name>.cu`` built with its flags and the extra
    ``-D`` flags ``defines`` (compile-time variants), named by a hash of
    the source and every flag."""
    src = CSRC / f"{name}.cu"
    flags = " ".join(BASE_FLAGS + EXTRA_FLAGS.get(name, ()) + tuple(defines))
    h = hashlib.sha1(src.read_bytes() + flags.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str, defines: tuple = ()):
    out = lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file per process and thread: threads may build at once
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *BASE_FLAGS, *EXTRA_FLAGS.get(name, ()), *defines,
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    BUILD_SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
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


def build_log(name: str) -> str:
    """What nvcc printed when it built ``csrc/<name>.cu`` ("" if the
    library was not built here)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _open(path: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes``/``restype`` set from ``signatures`` (entry -> argtypes)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = _LIBS[name] = _open(lib_path(name), signatures)
        return lib


def load_variant(name: str, signatures: Dict[str, tuple],
                 defines: tuple) -> ctypes.CDLL:
    """A build of ``csrc/<name>.cu`` with extra ``-D`` flags (compile-time
    variants that scripts and card tests time or hold against the
    default build), beside the default one in the build directory.
    Threads may build several at once."""
    defines = tuple(defines)
    _finish(name, _start(name, defines))
    return _open(lib_path(name, defines), signatures)


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` (a torch.device or an index),
    by torch's raw-stream query where the build has it (no Stream object:
    the pivot loop's launch path)."""
    import torch
    idx = device if isinstance(device, int) else device.index
    if idx is None:
        idx = torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream(idx).cuda_stream
    return raw(idx)


P = ctypes.c_void_p
I64 = ctypes.c_int64
F64 = ctypes.c_double
