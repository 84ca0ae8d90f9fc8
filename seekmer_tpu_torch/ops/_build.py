"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for ``sm_90a``,
all started together, and the objects are linked into one shared library
with a plain C interface, at first use, into ``build/seekmer_tpu_torch/``
at the repository root. One ``nvcc`` per source keeps the build as long
as its slowest source rather than the sum of all, as sources are added
under the fixed time limit of ``chip_smoke.py``, which builds them all.
The library's file name carries a hash of the sources and flags, so an
edited source is never served by a stale build; ``-Xptxas -v`` writes each
kernel's registers and spills to a log of the same name beside it
(:func:`log_path`), so the report always describes the library loaded.
It is loaded with ``ctypes``; every pointer and the stream are passed as
``c_void_p``, integers as ``c_int64`` and floating-point parameters as
``c_double``, and every C entry returns a CUDA error code (0 on success),
which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module, and
the build happens only when a CUDA tensor first reaches a kernel wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "seekmer_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libseekmer_kernels_{h.hexdigest()[:12]}.so"


def log_path() -> Path:
    """The compiler's report (registers, spills) of :func:`library_path`'s
    build."""
    return library_path().with_suffix(".log")


def _run_all(cmds):
    """Run the commands concurrently; returns (log text, failed stderr)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    text, failed = [], []
    for c, p in zip(cmds, procs):
        so, se = p.communicate()
        text.append(" ".join(c) + "\n" + so + se)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)} ({p.returncode}):\n{se}")
    return "".join(text), failed


def build() -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. The compiler's report (registers, spills) is kept
    beside it (:func:`log_path`)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, p.stem + ".o") for p in cu]
        log, failed = _run_all(
            [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(p)]
             for p, o in zip(cu, objs)])
        if not failed:
            tmp = os.path.join(tmpdir, "lib.so")
            link, failed = _run_all(
                [[_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
            log += link
        log_path().write_text(log)
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        # atomic: a concurrent loader sees all or nothing
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


@functools.lru_cache(maxsize=None)
def function(name: str, n_ptr: int, n_int: int, n_dbl: int = 0):
    """The C entry ``name`` taking ``n_ptr`` pointers (c_void_p, the stream
    last among them), then ``n_int`` 64-bit integers, then ``n_dbl``
    doubles, returning int."""
    fn = getattr(_lib(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int
                   + [ctypes.c_double] * n_dbl)
    fn.restype = ctypes.c_int
    return fn


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Reject what the kernel does not take: tensors off the card, on
    different cards, or not contiguous."""
    # device indices as ints (-1 on the CPU): comparing torch.device
    # objects costs several times more host time a call
    dev = tensors[0].get_device()
    for t in tensors:
        if t.get_device() != dev or dev < 0:
            raise ValueError(f"{name}: every tensor must be on "
                             f"{tensors[0].device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
