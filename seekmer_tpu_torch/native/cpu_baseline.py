"""ctypes loader of the compiled single-core CPU baseline mapper
(``cpu_baseline.c``): the port's copy of
``seekmer_tpu/native/cpu_baseline.py``.

The baseline is the denominator of the project's throughput target, >= 10x
the reads/s of one CPU core running the reference's algorithm class
(``BASELINE.json:5``): a compiled single-threaded rolling-k-mer hash-probe
loop with the per-read semantics of the device path (every valid window
probed, or with ``use_skip`` a jump by the hit's EC run length; sorted
distinct EC signature; count per distinct signature). ``chip_smoke.py``
times it on the card's host beside the port's map step and map stage.

Repaired against the copied source: the library is built into
``build/seekmer_tpu_torch/`` with the source's hash in its name
(``native.build_c``), not beside the source by modification time; a failed
build raises ``RuntimeError`` and nothing falls back to a slower mapper;
``max_ecs`` above 64 raises ``ValueError`` where the source clamped it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..encoding import join_key
from . import build_c

_SRC = Path(__file__).resolve().parent / "cpu_baseline.c"
MAX_ECS = 64  # the C side's per-read EC set (MAX_ECS in cpu_baseline.c)


def build() -> Path:
    """The library's path, built first if needed."""
    return build_c(_SRC, "libseekmer_cpu")


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded shared library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
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


class CpuBaselineMapper:
    """Single-threaded compiled mapper over a ``KMerIndex``'s occupied table
    and stash rows, with its own open-addressing signature table of
    ``2**sig_bits`` slots (``sig_keys``: 64-bit fingerprints, 0 = empty;
    ``sig_counts``) that every ``map`` call adds to. Close it, or use it
    as a context manager: the C table is ~13 bytes a slot, two slots a
    k-mer or more."""

    def __init__(self, index, sig_bits: int = 20):
        self._h = None
        self._lib = get_lib()
        keys, ecs, aux = [], [], []
        for rows in (index.table, index.stash):
            occ = rows[rows[:, 0] >= 0]
            keys.append(join_key(occ[:, 0], occ[:, 1], index.k))
            ecs.append(occ[:, 2].astype(np.int32))
            # per-key EC run lengths: the skip arm's jump
            aux.append(np.clip(occ[:, 3], 0, 255).astype(np.uint8))
        keys, ecs, aux = (np.ascontiguousarray(np.concatenate(a))
                          for a in (keys, ecs, aux))
        self._h = self._lib.seekmer_cpu_build(
            _ptr(keys, ctypes.c_uint64), _ptr(ecs, ctypes.c_int32),
            _ptr(aux, ctypes.c_uint8), keys.size, index.k)
        if not self._h:
            raise MemoryError("cpu baseline index allocation failed")
        self.sig_size = 1 << sig_bits
        self.sig_keys = np.zeros(self.sig_size, np.uint64)
        self.sig_counts = np.zeros(self.sig_size, np.int64)
        # occupancy carried across map() calls, so that the C side's
        # load-0.5 overflow bound holds for the table's whole lifetime
        self._sig_used = np.zeros(1, np.int64)

    def map(self, codes: np.ndarray, max_ecs: int = 16,
            use_skip: bool = False) -> int:
        """Map uint8[B, L] code rows (0-3 a base, 4 an invalid base or
        padding); returns the mapped reads and adds their signatures to the
        table. ``use_skip`` is the reference's skipping heuristic: after a
        hit, the next windows of its EC run are not probed (the same
        signatures up to a ~1e-7 a window error-collision caveat)."""
        if max_ecs > MAX_ECS:
            raise ValueError(f"max_ecs {max_ecs} > {MAX_ECS}: the baseline "
                             f"holds at most {MAX_ECS} distinct ECs a read")
        if self._h is None:
            raise ValueError("the baseline mapper is closed")
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        if codes.ndim != 2:
            raise ValueError(f"codes must be (B, L), got {codes.shape}")
        B, L = codes.shape
        n = self._lib.seekmer_cpu_map(
            self._h, _ptr(codes, ctypes.c_uint8), B, L, max_ecs,
            _ptr(self.sig_keys, ctypes.c_uint64),
            _ptr(self.sig_counts, ctypes.c_int64), self.sig_size,
            _ptr(self._sig_used, ctypes.c_int64), 1 if use_skip else 0)
        if n == -1:
            raise RuntimeError("baseline signature table overflow; raise "
                               "sig_bits")
        if n < 0:
            raise ValueError(f"seekmer_cpu_map refused max_ecs {max_ecs}")
        return int(n)

    @property
    def distinct_signatures(self) -> int:
        return int((self.sig_keys != 0).sum())

    @property
    def total_mapped(self) -> int:
        return int(self.sig_counts.sum())

    def close(self) -> None:
        if self._h:
            self._lib.seekmer_cpu_free(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
