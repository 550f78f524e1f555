"""Build and load the port's CUDA kernels; count their launches.

Each ``hetu_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` on first
use into a shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <name>-<hash>.so <name>.cu

A launch made while a CUDA graph is being captured runs only when the
graph is replayed: :func:`counting_into` sends the counts of a capture
to the graph's own tally, and :func:`add_launches` adds that tally to
the counters at each replay.

The output lives under ``build/hetu_tpu_torch/`` at the checkout root,
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one loads at once. :func:`build` starts one
``nvcc`` per source, all at the same time. A failed build raises with
nvcc's stderr. Nothing here runs at import time: this module imports on
a host without ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hetu_tpu_torch"
SOURCES = ("paged_attention", "flash_fwd", "flash_bwd", "fused_ce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple, object] = {}
_LAUNCHES: dict[str, int] = {}
# the autograd engine runs a CUDA backward (and its launches) on a thread
# of its own
_COUNT_LOCK = threading.Lock()
# the tally of the graph being captured, if any, and the thread capturing
# it: one capture at a time per process. A launch goes to the tally when
# that thread makes it, or when the launching thread's stream is capturing
# (a backward captured with its forward launches from the autograd
# engine's thread).
_CAPTURE: tuple = (None, None)


def _stream_capturing() -> bool:
    import torch
    return torch.cuda.is_current_stream_capturing()


# -- launch counters ---------------------------------------------------------
def count_launch(name: str) -> None:
    """Called by a wrapper right after its kernel launched (or, inside
    :func:`counting_into`, was captured into a graph)."""
    tally, thread = _CAPTURE
    captured = tally is not None and (threading.get_ident() == thread
                                      or _stream_capturing())
    with _COUNT_LOCK:
        into = tally if captured else _LAUNCHES
        into[name] = into.get(name, 0) + 1


@contextlib.contextmanager
def counting_into(tally: dict):
    """Inside the block, launches counted on this thread, or on any
    thread's capturing stream, go to ``tally`` (the graph being
    captured) instead of the counters."""
    global _CAPTURE
    prev = _CAPTURE
    _CAPTURE = (tally, threading.get_ident())
    try:
        yield tally
    finally:
        _CAPTURE = prev


def add_launches(tally: dict) -> None:
    """One replay of a captured graph: its launches, by name."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            _LAUNCHES[name] = _LAUNCHES.get(name, 0) + n


def launch_counts() -> dict:
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        _LAUNCHES.clear()


# -- build -------------------------------------------------------------------
def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Compile the named kernels (default: all) in parallel. Returns
    ``{name: {"path", "seconds", "cached", "ptxas"}}`` — ``ptxas`` is the
    assembler's register/shared-memory/spill report."""
    names = list(names or SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        dst = _target(name)
        log = dst.with_suffix(".log")
        if dst.exists():
            out[name] = {"path": str(dst), "seconds": 0.0, "cached": True,
                         "ptxas": log.read_text() if log.exists() else ""}
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, dst, log)
    errors = []
    for name, (proc, tmp, dst, log) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        log.write_text(stderr)
        os.replace(tmp, dst)
        out[name] = {"path": str(dst),
                     "seconds": round(time.perf_counter() - t0, 3),
                     "cached": False, "ptxas": stderr}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def kernel(name: str, symbol: str, argtypes: list):
    """``(library, launcher)`` for launcher ``symbol`` of source ``name``:
    the library is built first if needed and loaded once; each launcher
    gets its ``argtypes`` and an int ``restype`` once, at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build([name])[name]["path"]
            lib = ctypes.CDLL(path)
            lib.hetu_cuda_error_string.argtypes = [ctypes.c_int]
            lib.hetu_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        fn = _FNS.get((name, symbol))
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[(name, symbol)] = fn
        return lib, fn


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launcher."""
    if err:
        msg = lib.hetu_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
