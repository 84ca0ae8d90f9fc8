"""Pre-packed 2-bit batch cache: the port's copy of
``seekmer_tpu/io/pack_cache.py``, with fault 2 repaired.

A first run over a library decodes, parses and bucket-packs as usual while
it tees every batch, 2-bit packed as it is uploaded, into flat binary
files; later runs map those files and feed the mapper directly: no gzip
inflate, no FASTQ parse, no bucket copy, no 2-bit pack. A hit never
decodes: its batches are ``np.memmap`` slices, copied once into pinned
memory by the upload (``utils/prefetch``).

Layout of ``<dir>`` (default: ``<first fastq>.smpack``), the JAX
package's byte for byte but for the build id:
  meta.json — version, build id, batching config, source file signatures,
              the ordered [bucket, n_real] batch list; written atomically
              on clean completion, so an aborted build leaves an invalid
              cache that is rebuilt.
  c1_<W>.bin / bad1_<W>.bin / l1_<W>.bin — per length bucket W: 2-bit
    code rows ((W+3)//4 B a row), invalid masks ((W+7)//8 B a row), int32
    lengths, in batch order (batch j of bucket W = rows [j*B, (j+1)*B)).
    Paired runs add c2_/bad2_/l2_.

Batches read from the cache carry resume cursors ({"v": "pack1", "s1":
[next batch index, 0], "build": id}) through the checkpoint files of
``utils/checkpoint``, so ``--checkpoint`` works on cached runs; the two
cursor kinds refuse each other.

Fault 2 (the JAX package resumes a cache by a bare batch index: a cache
rebuilt since the checkpoint, possibly in another batch order, would
double-count some reads and skip others) is repaired here: every build
draws a random id, written into ``meta.json`` and into every cursor, and
``PackCacheSource.restore`` refuses a cursor whose id is missing or
differs. A cache with no id (one the JAX package built) counts as stale
and is rebuilt.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from collections import Counter
from typing import Iterable, Iterator, List

import numpy as np

from ..config import MapConfig
from .fastq import ReadBatch

log = logging.getLogger(__name__)

VERSION = 1
CURSOR_V = "pack1"  # ReadBatch.cursor["v"] of cache cursors


def default_cache_dir(paths1: List[str]) -> str:
    return os.path.abspath(str(paths1[0])) + ".smpack"


def _source_sig(paths1, paths2) -> list:
    out = []
    for p in list(paths1) + list(paths2 or []):
        st = os.stat(p)
        out.append([os.path.abspath(p), st.st_size, st.st_mtime_ns])
    return out


def _cfg_sig(cfg: MapConfig, paired: bool) -> dict:
    return {
        "batch_size": cfg.batch_size,
        "length_bucket": cfg.length_bucket,
        "max_read_len": cfg.max_read_len,
        "paired": paired,
    }


def cache_valid(cache_dir: str, cfg: MapConfig, paths1, paths2) -> bool:
    """True when a complete cache matching the sources and the batching
    config exists (meta.json is only written on clean completion) and
    carries a build id."""
    try:
        with open(os.path.join(cache_dir, "meta.json")) as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return False
    if meta.get("version") != VERSION or not meta.get("build_id"):
        return False
    if meta.get("cfg") != _cfg_sig(cfg, paths2 is not None):
        return False
    try:
        return meta.get("sources") == _source_sig(paths1, paths2)
    except OSError:
        return False


def _columns(w: int, paired: bool) -> dict:
    """The files of bucket width ``w``: name -> (dtype, bytes a row of a
    2-D file, or 0 for a vector of int32 lengths)."""
    w4, w8 = (w + 3) // 4, (w + 7) // 8
    cols = {"c1": (np.uint8, w4), "bad1": (np.uint8, w8), "l1": (np.int32, 0)}
    if paired:
        cols.update(c2=(np.uint8, w4), bad2=(np.uint8, w8),
                    l2=(np.int32, 0))
    return cols


class _BucketFiles:
    """Write handles of one bucket width's files."""

    def __init__(self, d: str, w: int, paired: bool):
        self.fh = {n: open(os.path.join(d, f"{n}_{w}.bin"), "wb")
                   for n in _columns(w, paired)}

    def append(self, **arrays) -> None:
        for name, arr in arrays.items():
            if arr is not None:
                self.fh[name].write(np.ascontiguousarray(arr).tobytes())

    def close(self) -> None:
        for fh in self.fh.values():
            fh.close()


def write_through(batches: Iterable[ReadBatch], cache_dir: str,
                  cfg: MapConfig, paths1, paths2) -> Iterator[ReadBatch]:
    """Tee unpacked ingest batches into the cache while yielding them 2-bit
    packed (packed here once, in GIL-released C; the upload's pack step
    passes packed batches through). meta.json, with this build's random
    id, is written only when the stream completes cleanly."""
    from ..native.packer import pack_codes_2bit_native

    paired = paths2 is not None
    os.makedirs(cache_dir, exist_ok=True)
    build_id = os.urandom(16).hex()
    files: dict[int, _BucketFiles] = {}
    batch_meta: list = []
    try:
        for b in batches:
            if b.pad_len is not None:
                raise ValueError("pack cache writer expects unpacked "
                                 "ingest batches")
            w = b.codes.shape[1]
            c1, bad1 = pack_codes_2bit_native(b.codes)
            c2 = bad2 = None
            if b.codes2 is not None:
                c2, bad2 = pack_codes_2bit_native(b.codes2)
            bf = files.get(w)
            if bf is None:
                bf = files[w] = _BucketFiles(cache_dir, w, paired)
            bf.append(c1=c1, bad1=bad1, l1=np.asarray(b.lengths, np.int32),
                      c2=c2, bad2=bad2,
                      l2=None if b.lengths2 is None
                      else np.asarray(b.lengths2, np.int32))
            batch_meta.append([int(w), int(b.n_real)])
            yield dataclasses.replace(b, codes=c1, bad=bad1, codes2=c2,
                                      bad2=bad2, pad_len=w)
    finally:
        for bf in files.values():
            bf.close()
    meta = {
        "version": VERSION,
        "build_id": build_id,
        "cfg": _cfg_sig(cfg, paired),
        "sources": _source_sig(paths1, paths2),
        "batches": batch_meta,
    }
    tmp = os.path.join(cache_dir, "meta.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
    os.replace(tmp, os.path.join(cache_dir, "meta.json"))
    log.info("pack cache written: %s (%d batches, build %s)", cache_dir,
             len(batch_meta), build_id)


class PackCacheSource:
    """Memory-mapped batch source over a complete cache, with the
    ``restore()`` contract of ``CheckpointableBatchSource`` (the cursor is
    the index of the next batch and this build's id; a resume skips and
    re-reads nothing). A file that is missing or shorter than meta.json
    says raises here, before any batch is read."""

    def __init__(self, cache_dir: str, cfg: MapConfig):
        self.dir = cache_dir
        self.cfg = cfg
        with open(os.path.join(cache_dir, "meta.json")) as fh:
            self.meta = json.load(fh)
        if self.meta.get("version") != VERSION:
            raise ValueError(f"pack cache version {self.meta.get('version')}"
                             f" != {VERSION}")
        if self.meta["cfg"]["batch_size"] != cfg.batch_size:
            raise ValueError("pack cache batch_size mismatch")
        self.build_id = self.meta.get("build_id")
        if not self.build_id:
            raise ValueError(f"pack cache {cache_dir} has no build id (built "
                             "by another package); rebuild it")
        self.paired = self.meta["cfg"]["paired"]
        B = cfg.batch_size
        for w, n in Counter(w for w, _ in self.meta["batches"]).items():
            for name, (dt, cols) in _columns(w, self.paired).items():
                path = os.path.join(cache_dir, f"{name}_{w}.bin")
                want = n * B * (cols or np.dtype(dt).itemsize)
                size = os.path.getsize(path)
                if size < want:
                    raise ValueError(f"pack cache file {path} holds {size} "
                                     f"bytes, meta.json needs {want}")
        self._start = 0

    def restore(self, state: dict) -> None:
        if state.get("v") != CURSOR_V:
            raise ValueError(
                "checkpoint cursor is a file-offset cursor (taken without "
                "--pack-cache); resume without --pack-cache, or delete the "
                "checkpoint to start fresh from the cache")
        if state.get("paired", False) != self.paired:
            raise ValueError("checkpoint cursor pairing does not match "
                             "the pack cache")
        if state.get("build") != self.build_id:
            raise ValueError(
                f"the pack cache {self.dir} was rebuilt since the checkpoint "
                f"was taken (checkpoint build {state.get('build')}, cache "
                f"build {self.build_id}): its batches may be in another "
                "order, so resuming would count some reads twice and skip "
                "others; delete the checkpoint to start fresh")
        self._start = int(state["s1"][0])

    def __iter__(self) -> Iterator[ReadBatch]:
        B = self.cfg.batch_size
        maps: dict[int, dict] = {}
        row_cursor: dict[int, int] = {}

        def bucket_maps(w: int) -> dict:
            m = maps.get(w)
            if m is None:
                m = {}
                for name, (dt, cols) in _columns(w, self.paired).items():
                    mm = np.memmap(os.path.join(self.dir, f"{name}_{w}.bin"),
                                   dtype=dt, mode="r")
                    m[name] = mm.reshape(-1, cols) if cols else mm
                maps[w] = m
            return m

        for i, (w, n_real) in enumerate(self.meta["batches"]):
            j = row_cursor.get(w, 0)
            row_cursor[w] = j + B
            if i < self._start:
                continue
            m = bucket_maps(w)
            sl = slice(j, j + B)
            weights = np.zeros(B, np.int32)
            weights[:n_real] = 1
            cursor = {"v": CURSOR_V, "paired": self.paired,
                      "s1": [i + 1, 0], "s2": None, "pending": {},
                      "build": self.build_id}
            yield ReadBatch(
                codes=m["c1"][sl], lengths=m["l1"][sl], weights=weights,
                codes2=m["c2"][sl] if self.paired else None,
                lengths2=m["l2"][sl] if self.paired else None,
                bad=m["bad1"][sl],
                bad2=m["bad2"][sl] if self.paired else None,
                pad_len=w, n_real_cached=int(n_real), cursor=cursor)
