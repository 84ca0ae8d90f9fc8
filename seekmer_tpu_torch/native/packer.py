"""ctypes loader and drivers of the port's native host code (``packer.c``):
the streaming FASTQ reader (``PackedFileStream``, which also opens at and
tells an uncompressed byte offset: a map checkpoint's resume cursor), the
bucketer (whose pending rows a checkpoint carries), the 2-bit pack the pack
cache writes, and the index build's radix sort. The port's copy of
``seekmer_tpu/native/packer.py``.

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
    lib.seekmer_tell.restype = ctypes.c_long
    lib.seekmer_tell.argtypes = [ctypes.c_void_p]
    lib.seekmer_open_at.restype = ctypes.c_void_p
    lib.seekmer_open_at.argtypes = [ctypes.c_char_p, ctypes.c_long]
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
    lib.seekmer_bucketer_pending.restype = ctypes.c_long
    lib.seekmer_bucketer_pending.argtypes = [
        ctypes.c_void_p, ctypes.c_long, u8p, i32p, u8p, i32p]
    lib.seekmer_bucketer_nb.restype = ctypes.c_long
    lib.seekmer_bucketer_nb.argtypes = [ctypes.c_void_p]
    lib.seekmer_pack2bit.restype = None
    lib.seekmer_pack2bit.argtypes = [u8p, ctypes.c_long, ctypes.c_long, u8p,
                                     u8p]
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
    with PackedFileStream(path, max_len) as s:
        while True:
            chunk = s.next_chunk(chunk_reads)
            if chunk is None:
                return
            yield chunk


class PackedFileStream:
    """The C streaming reader as an object: ``next_chunk`` and ``tell``.

    ``tell()`` is the uncompressed byte offset of the next unparsed record;
    ``start_offset`` reopens there (a plain file seeks; a .gz file is
    inflated and discarded up to it inside one C call)."""

    def __init__(self, path: str, max_len: int, start_offset: int = 0):
        self._lib = get_lib()
        self.path = path
        self.max_len = max_len
        if start_offset:
            self._h = self._lib.seekmer_open_at(os.fsencode(path),
                                                start_offset)
        else:
            self._h = self._lib.seekmer_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open FASTQ file at offset "
                          f"{start_offset}: {path}")

    def next_chunk(self, max_reads: int):
        """(codes uint8[n, max_len], lengths int32[n]) or None at EOF."""
        codes = np.empty((max_reads, self.max_len), dtype=np.uint8)
        lengths = np.empty(max_reads, dtype=np.int32)
        n = self._lib.seekmer_next(self._h, _u8p(codes), _i32p(lengths),
                                   max_reads, self.max_len)
        if n == 0:
            return None
        if n == -1:
            raise ValueError(f"malformed FASTQ input in {self.path}")
        if n < 0:
            raise OSError(f"I/O error reading {self.path}")
        return codes[:n], lengths[:n]

    def tell(self) -> int:
        return int(self._lib.seekmer_tell(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def pack_codes_2bit_native(codes: np.ndarray):
    """The C form of ``encoding.pack_codes_2bit`` (the same layout):
    (packed uint8[n, (L+3)//4], bad uint8[n, (L+7)//8]), one GIL-released
    call a batch."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n, L = codes.shape
    out = np.empty((n, (L + 3) // 4), np.uint8)
    bad = np.empty((n, (L + 7) // 8), np.uint8)
    get_lib().seekmer_pack2bit(_u8p(codes), n, L, _u8p(out), _u8p(bad))
    return out, bad


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
    fixed-shape (B, W) batches as buckets fill, every call GIL-released.
    ``pending_state`` exports the rows of partial buckets for a checkpoint
    and ``restore_pending`` feeds them back."""

    def __init__(self, batch_size: int, max_len: int, length_bucket: int,
                 paired: bool):
        self._lib = get_lib()
        self.B = batch_size
        self.max_len = max_len
        self.lb = length_bucket
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

    def pending_state(self) -> dict:
        """The pending (not yet full) rows of every bucket, copied:
        {bucket_width: {"c1", "l1"[, "c2", "l2"]}}, each (fill, W)."""
        out = {}
        for idx in range(self._lib.seekmer_bucketer_nb(self._h)):
            fill = self._lib.seekmer_bucketer_pending(
                self._h, idx, None, None, None, None)
            if fill == 0:
                continue
            w = min((idx + 1) * self.lb, self.max_len)
            d = {"c1": np.empty((fill, w), np.uint8),
                 "l1": np.empty(fill, np.int32)}
            if self.paired:
                d["c2"] = np.empty((fill, w), np.uint8)
                d["l2"] = np.empty(fill, np.int32)
            self._lib.seekmer_bucketer_pending(
                self._h, idx, _u8p(d["c1"]), _i32p(d["l1"]),
                _u8p(d["c2"]) if self.paired else None,
                _i32p(d["l2"]) if self.paired else None)
            out[int(w)] = d
        return out

    def restore_pending(self, pending: dict) -> None:
        """Feed a ``pending_state`` back: bucketing is deterministic by
        length, so each row lands in its bucket again, in order."""
        for _, d in sorted(pending.items()):
            c1 = np.asarray(d["c1"], np.uint8)
            fill, w = c1.shape
            wide = [np.full((fill, self.max_len), 4, np.uint8)]
            wide[0][:, :w] = c1
            if self.paired:
                wide.append(np.full((fill, self.max_len), 4, np.uint8))
                wide[1][:, :w] = np.asarray(d["c2"], np.uint8)
            if self.feed(wide[0], np.asarray(d["l1"], np.int32),
                         wide[1] if self.paired else None,
                         np.asarray(d["l2"], np.int32) if self.paired
                         else None):
                raise ValueError("restored pending rows filled a batch: a "
                                 "snapshot holds no full bucket")

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_bucketer_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
