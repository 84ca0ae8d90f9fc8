"""ctypes loader and drivers of the port's native host code (``packer.c``):
the streaming FASTQ reader, the bucketer and the index build's radix sort.
The port's copy of ``seekmer_tpu/native/packer.py``.

The library is built from ``packer.c`` with the system C compiler at first
use, into ``build/seekmer_tpu_torch/`` at the repository root (the
directory the CUDA kernels are built into, ``ops/_build.py``), never
beside the source. Its file name carries a hash of the source, so an
edited source is never served by a stale build. There is no pure-Python
fallback: without a C compiler and zlib the port's ingest and its index
build above ``index.build._NATIVE_SORT_MIN`` pairs raise.
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
from typing import Iterator

import numpy as np

_SRC = Path(__file__).resolve().parent / "packer.c"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seekmer_tpu_torch"


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    return _BUILD_DIR / f"libseekmer_packer_{digest}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError("no C compiler: the native packer cannot be built")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        r = subprocess.run([cc, "-O3", "-shared", "-fPIC", "-pthread",
                            str(_SRC), "-lz", "-o", so],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
        os.replace(so, out)  # atomic: a concurrent loader sees all or none
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded shared library, built first if needed."""
    lib = ctypes.CDLL(str(_build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.seekmer_open.restype = ctypes.c_void_p
    lib.seekmer_open.argtypes = [ctypes.c_char_p]
    lib.seekmer_next.restype = ctypes.c_long
    lib.seekmer_next.argtypes = [ctypes.c_void_p, u8p, i32p, ctypes.c_long,
                                 ctypes.c_long]
    lib.seekmer_close.restype = None
    lib.seekmer_close.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_new.restype = ctypes.c_void_p
    lib.seekmer_bucketer_new.argtypes = [
        ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_int]
    lib.seekmer_bucketer_free.restype = None
    lib.seekmer_bucketer_free.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_feed.restype = ctypes.c_long
    lib.seekmer_bucketer_feed.argtypes = [
        ctypes.c_void_p, u8p, i32p, u8p, i32p, ctypes.c_long]
    lib.seekmer_bucketer_ready_width.restype = ctypes.c_long
    lib.seekmer_bucketer_ready_width.argtypes = [ctypes.c_void_p]
    lib.seekmer_bucketer_pop.restype = ctypes.c_long
    lib.seekmer_bucketer_pop.argtypes = [ctypes.c_void_p, u8p, i32p, u8p,
                                         i32p]
    lib.seekmer_bucketer_flush_one.restype = ctypes.c_long
    lib.seekmer_bucketer_flush_one.argtypes = [ctypes.c_void_p]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.seekmer_sort_pairs.restype = ctypes.c_long
    lib.seekmer_sort_pairs.argtypes = [
        u64p, i32p, ctypes.c_long, u64p, i32p, i64p, ctypes.c_int]
    return lib


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def stream_packed(path: str, max_len: int, chunk_reads: int = 16384
                  ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream a FASTQ(.gz) file as (codes uint8[n, max_len], lengths
    int32[n]) chunks: file read, gzip inflate, parse and pack inside ONE
    GIL-released ctypes call per chunk."""
    lib = get_lib()
    h = lib.seekmer_open(os.fsencode(path))
    if not h:
        raise OSError(f"cannot open FASTQ file: {path}")
    try:
        while True:
            codes = np.empty((chunk_reads, max_len), dtype=np.uint8)
            lengths = np.empty(chunk_reads, dtype=np.int32)
            n = lib.seekmer_next(h, _u8p(codes), _i32p(lengths), chunk_reads,
                                 max_len)
            if n == 0:
                return
            if n == -1:
                raise ValueError(f"malformed FASTQ input in {path}")
            if n < 0:
                raise OSError(f"I/O error reading {path}")
            yield codes[:n], lengths[:n]
    finally:
        lib.seekmer_close(h)


def sort_pairs_native(keys: np.ndarray, tids: np.ndarray,
                      nthreads: int = 0):
    """Stable sort of (key, tid) pairs by key with the threaded C radix
    sort. Returns (sorted_keys, sorted_tids, key_rank): byte-identical to
    ``np.argsort(keys, kind='stable')``, the gathers and the rank scatter,
    for keys of any width."""
    keys = np.ascontiguousarray(keys, np.uint64)
    tids = np.ascontiguousarray(tids, np.int32)
    n = keys.size
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 8)
    keys_out = np.empty(n, np.uint64)
    tids_out = np.empty(n, np.int32)
    rank = np.empty(n, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    got = get_lib().seekmer_sort_pairs(
        keys.ctypes.data_as(u64p), _i32p(tids), n,
        keys_out.ctypes.data_as(u64p), _i32p(tids_out),
        rank.ctypes.data_as(i64p), nthreads)
    if got < 0:
        raise MemoryError(f"radix sort of {n} pairs: allocation failed")
    return keys_out, tids_out, rank


class Bucketer:
    """C-side bucket placement: feed decoded (codes, lengths) chunks, pop
    fixed-shape (B, W) batches as buckets fill, every call GIL-released."""

    def __init__(self, batch_size: int, max_len: int, length_bucket: int,
                 paired: bool):
        self._lib = get_lib()
        self.B = batch_size
        self.paired = paired
        self._h = self._lib.seekmer_bucketer_new(
            batch_size, max_len, length_bucket, 1 if paired else 0)
        if not self._h:
            raise MemoryError("bucketer allocation failed")

    def feed(self, c1, l1, c2=None, l2=None) -> int:
        """Add decoded rows (width max_len); returns ready batch count."""
        c1 = np.ascontiguousarray(c1, np.uint8)
        l1 = np.ascontiguousarray(l1, np.int32)
        if self.paired:
            c2 = np.ascontiguousarray(c2, np.uint8)
            l2 = np.ascontiguousarray(l2, np.int32)
        n = self._lib.seekmer_bucketer_feed(
            self._h, _u8p(c1), _i32p(l1),
            _u8p(c2) if self.paired else None,
            _i32p(l2) if self.paired else None, c1.shape[0])
        if n < 0:
            raise MemoryError("bucketer feed failed")
        return n

    def _pop_one(self):
        w = self._lib.seekmer_bucketer_ready_width(self._h)
        if w == 0:
            return None
        c1 = np.empty((self.B, w), np.uint8)
        l1 = np.empty(self.B, np.int32)
        c2 = np.empty((self.B, w), np.uint8) if self.paired else None
        l2 = np.empty(self.B, np.int32) if self.paired else None
        fill = self._lib.seekmer_bucketer_pop(
            self._h, _u8p(c1), _i32p(l1),
            _u8p(c2) if self.paired else None,
            _i32p(l2) if self.paired else None)
        return c1, l1, c2, l2, int(fill)

    def pop_ready(self):
        """Yield (c1, l1, c2, l2, n_real) for every ready batch."""
        while True:
            item = self._pop_one()
            if item is None:
                return
            yield item

    def flush(self):
        """Promote and yield every pending partial bucket (ascending W)."""
        while True:
            fill = self._lib.seekmer_bucketer_flush_one(self._h)
            if fill < 0:
                raise MemoryError("bucketer flush failed")
            if fill == 0:
                return
            item = self._pop_one()
            assert item is not None and item[4] == fill
            yield item

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_bucketer_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
