"""ctypes loader of the frozen single-core CPU baseline (``cpu_baseline.c``,
a copy of the program's ``native/cpu_baseline``): ``vs_baseline``'s
denominator, 10x its dense arm's fragments/s on the card's host.

The library is built with the system C compiler at first use into the
benchmark's cache directory, its source's hash in its name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "cpu_baseline.c"


def build(out_dir: Path) -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    out = Path(out_dir) / f"libgpubench_cpu_{digest}.so"
    if out.exists():
        return out
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler: the CPU baseline cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        so = os.path.join(tmp, "lib.so")
        r = subprocess.run([cc, "-O3", "-shared", "-fPIC", str(_SRC), "-o",
                            so], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
        os.replace(so, out)
    return out


def _lib(out_dir: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(out_dir)))
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.seekmer_cpu_build.restype = ctypes.c_void_p
    lib.seekmer_cpu_build.argtypes = [
        u64p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long, ctypes.c_int]
    lib.seekmer_cpu_free.restype = None
    lib.seekmer_cpu_free.argtypes = [ctypes.c_void_p]
    lib.seekmer_cpu_map.restype = ctypes.c_long
    lib.seekmer_cpu_map.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.c_long, ctypes.c_int, u64p, i64p, ctypes.c_long, i64p,
        ctypes.c_int]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def dense_rate(index, rows: np.ndarray, fragments: int, out_dir: Path,
               passes: int = 3, max_ecs: int = 16, sig_bits: int = 22):
    """The dense arm's best rate over ``passes`` timed passes of the code
    rows (a 256-row warm-up first), in fragments/s for ``fragments``
    fragments in ``rows``, and every pass's rate. ``index`` is the
    program's loaded index (its occupied table and stash rows, joined
    into 64-bit keys), the table every arm maps against."""
    lib = _lib(out_dir)
    n_lo = index.k - index.k // 2
    keys, ecs = [], []
    for tab in (index.table, index.stash):
        occ = tab[tab[:, 0] >= 0]
        keys.append((occ[:, 0].astype(np.uint64) << np.uint64(2 * n_lo))
                    | occ[:, 1].astype(np.uint64))
        ecs.append(occ[:, 2].astype(np.int32))
    keys = np.ascontiguousarray(np.concatenate(keys))
    ecs = np.ascontiguousarray(np.concatenate(ecs))
    aux = np.zeros(keys.size, np.uint8)
    h = lib.seekmer_cpu_build(_ptr(keys, ctypes.c_uint64),
                              _ptr(ecs, ctypes.c_int32),
                              _ptr(aux, ctypes.c_uint8), keys.size, index.k)
    if not h:
        raise MemoryError("CPU baseline index allocation failed")
    try:
        size = 1 << sig_bits
        sig_keys = np.zeros(size, np.uint64)
        sig_counts = np.zeros(size, np.int64)
        used = np.zeros(1, np.int64)
        rows = np.ascontiguousarray(rows, dtype=np.uint8)

        def one(r):
            n = lib.seekmer_cpu_map(
                h, _ptr(r, ctypes.c_uint8), r.shape[0], r.shape[1], max_ecs,
                _ptr(sig_keys, ctypes.c_uint64),
                _ptr(sig_counts, ctypes.c_int64), size,
                _ptr(used, ctypes.c_int64), 0)
            if n < 0:
                raise RuntimeError(f"seekmer_cpu_map returned {n}")
            return n

        one(np.ascontiguousarray(rows[:256]))
        rates = []
        for _ in range(passes):
            t0 = time.perf_counter()
            one(rows)
            rates.append(fragments / (time.perf_counter() - t0))
        return max(rates), rates
    finally:
        lib.seekmer_cpu_free(h)
