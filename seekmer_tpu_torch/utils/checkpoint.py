"""Batch-granular checkpoints and EM snapshots: the port's copy of
``seekmer_tpu/utils/checkpoint.py``, single process.

- A map checkpoint holds the signature table and the read stream's resume
  cursor: each stream's file index and uncompressed byte offset plus the
  rows of the partial buckets (``io/fastq.CheckpointableBatchSource``), or
  a pack-cache cursor (``io/pack_cache.PackCacheSource``). It is written
  every N batches; a resume seeks instead of re-decoding.
- An EM snapshot holds the iterate (alpha) and the iteration count, so a
  run restarts at every stage boundary and inside EM and the bootstrap.
  ``StageSnapshots`` keeps a run's EM and bootstrap snapshots beside its
  map checkpoint.

The files are the JAX package's: the same npz keys, ``FORMAT`` 3 and
``np.savez_compressed``, so a checkpoint written by either package loads in
the other. Four additions, which the JAX package ignores: a pack-cache
cursor's build id (``"build"``) and a file cursor's count of batches
made (``"batch"``, by which ``io/fastq.rank_batches`` deals batches to
ranks) in the cursor's metadata, the fragment-length estimator's
state (``fld_hist`` and the metadata's ``fld_fed``), so that a resumed
paired run estimates the FLD from the batches the uninterrupted run
sampled, and the table's count of complex reads (``complex``; zeros in a
file without it).

Multi-process checkpoints (``parallel/ckpt_mp.py``) add a sidecar a rank,
``<path>.host<i>.npz`` (``save_host_cursor``, ``load_host_cursor``): the
rank's cursor, read count, FLD state and the save's ``step``; the table
file's ``total_reads`` is then -1.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# 2: SigTable.key became bucketized (S/KB+1, KB, 2).
# 3: the stream cursor became offset-based (file index + byte offset +
#    pending partial-bucket rows); format-2 checkpoints are rejected.
FORMAT = 3

# Minimum seconds between two periodic EM or bootstrap snapshots: the
# fixed point syncs every ~2 s in pieces, and writing a config-scale
# alpha at each would dominate. The pin after the EM stage bypasses it.
SNAPSHOT_MIN_INTERVAL_S = 30.0

log = logging.getLogger(__name__)

_CURSOR_KEYS = ("v", "paired", "s1", "s2")
_CURSOR_EXTRAS = ("build", "batch")  # the port's, where a cursor has them


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _cursor_to_arrays(stream_state: Optional[dict]):
    """A cursor -> (json-able metadata, npz arrays of its pending rows)."""
    if stream_state is None:
        return None, {}
    cursor_meta = {k: stream_state[k] for k in _CURSOR_KEYS}
    for k in _CURSOR_EXTRAS:
        if k in stream_state:
            cursor_meta[k] = stream_state[k]
    cursor_meta["buckets"] = sorted(stream_state["pending"])
    arrays = {}
    for bucket, d in stream_state["pending"].items():
        for name, arr in d.items():
            arrays[f"pend_{bucket}_{name}"] = arr
    return cursor_meta, arrays


def _cursor_from_npz(z, cm: Optional[dict]) -> Optional[dict]:
    if cm is None:
        return None
    pending = {}
    for bucket in cm["buckets"]:
        pending[int(bucket)] = {
            name: z[f"pend_{bucket}_{name}"]
            for name in ("c1", "l1", "c2", "l2")
            if f"pend_{bucket}_{name}" in z.files
        }
    cursor = {k: cm[k] for k in _CURSOR_KEYS}
    for k in _CURSOR_EXTRAS:
        if k in cm:
            cursor[k] = cm[k]
    cursor["pending"] = pending
    return cursor


def save_map_checkpoint(path: str, table, total_reads: int,
                        stream_state: Optional[dict], step: int = 0,
                        fld: Optional[Tuple[np.ndarray, int]] = None
                        ) -> None:
    """Write the signature table, the resume cursor and, where given, the
    FLD estimator's (histogram, batches fed) atomically (a temporary file,
    then a rename). The table is read back to the host here, once a save.
    ``stream_state``'s pending rows are stored as npz arrays
    (``allow_pickle`` stays False)."""
    cursor_meta, arrays = _cursor_to_arrays(stream_state)
    meta = dict(format=FORMAT, total_reads=int(total_reads),
                cursor=cursor_meta, step=int(step))
    if fld is not None:
        arrays["fld_hist"] = _host(fld[0])
        meta["fld_fed"] = int(fld[1])
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            key=_host(table.key),
            count=_host(table.count),
            sig=_host(table.sig),
            overflow=_host(table.overflow),
            collisions=_host(table.collisions),
            ec_count=_host(table.ec_count),
            complex=_host(table.complex),
            **arrays,
        )
    os.replace(tmp, path)


def load_map_checkpoint(path: str, device="cuda", with_step=False,
                        multiprocess=False):
    """(SigTable on ``device``, total_reads, cursor, fld), or None when
    there is no file; ``fld`` is the FLD estimator's (histogram, batches
    fed), None in a file without it (the JAX package's); ``with_step``
    appends the save's ``step``. Raises on another format, and on a
    multi-process save unless ``multiprocess`` (its read counts live in
    the ranks' sidecars)."""
    from ..map.signature import sig_table_from_numpy

    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT:
            raise ValueError(f"checkpoint format {meta['format']} != {FORMAT}")
        if (meta["total_reads"] < 0) != multiprocess:
            raise ValueError(
                f"checkpoint {path} was written by a "
                f"{'multi' if meta['total_reads'] < 0 else 'single'}"
                f"-process run; restore it under the process count that "
                "wrote it, or delete the checkpoint files to start fresh")
        fields = {name: z[name] for name in ("key", "count", "sig",
                                              "overflow")}
        # absent in older format-3 files: zeros of overflow's shape, and
        # the (1,) placeholder of the per-EC vector (adapt_ec_count)
        fields["collisions"] = (z["collisions"] if "collisions" in z.files
                                else np.zeros_like(z["overflow"]))
        fields["ec_count"] = (z["ec_count"] if "ec_count" in z.files
                              else np.zeros(1, np.int32))
        if "complex" in z.files:  # else zeros (sig_table_from_numpy)
            fields["complex"] = z["complex"]
        cursor = _cursor_from_npz(z, meta["cursor"])
        fld = ((z["fld_hist"], meta["fld_fed"]) if "fld_hist" in z.files
               else None)
    out = (sig_table_from_numpy(fields, device), meta["total_reads"],
           cursor, fld)
    return out + (meta.get("step", 0),) if with_step else out


def host_cursor_path(path: str, rank: int) -> str:
    return f"{path}.host{rank}.npz"


def save_host_cursor(path: str, rank: int, stream_state: Optional[dict],
                     total_reads: int, step: int,
                     fld: Optional[Tuple[np.ndarray, int]] = None) -> None:
    """A rank's sidecar of a multi-process checkpoint: its cursor, read
    count and FLD state, stamped with the save's ``step`` so that a
    restore can prove the table file and every sidecar came from one
    save. The JAX package's keys, plus ``fld_hist``/``fld_fed``."""
    cursor_meta, arrays = _cursor_to_arrays(stream_state)
    meta = dict(format=FORMAT, total_reads=int(total_reads),
                cursor=cursor_meta, step=int(step), process_index=int(rank))
    if fld is not None:
        arrays["fld_hist"] = _host(fld[0])
        meta["fld_fed"] = int(fld[1])
    out = host_cursor_path(path, rank)
    tmp = out + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **arrays)
    os.replace(tmp, out)


def load_host_cursor(path: str, rank: int):
    """(cursor, total_reads, step, fld) of a rank's sidecar, or None when
    it is absent."""
    out = host_cursor_path(path, rank)
    if not os.path.exists(out):
        return None
    with np.load(out, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT:
            raise ValueError(f"cursor format {meta['format']} != {FORMAT}")
        fld = ((z["fld_hist"], meta["fld_fed"]) if "fld_hist" in z.files
               else None)
        return (_cursor_from_npz(z, meta["cursor"]), meta["total_reads"],
                meta.get("step", 0), fld)


def adapt_ec_count(table, target_shape):
    """Fit a loaded table's per-EC vector to the mapper's shape: a file
    from before the vector carries the (1,) zero placeholder (every count
    lives in the CAS rows), for which zeros are exact; any nonzero vector
    of another shape means another index and is refused."""
    ec = table.ec_count
    if tuple(ec.shape) == tuple(target_shape):
        return table
    if bool(ec.any()):
        raise ValueError(
            "checkpoint's per-EC direct counts have shape "
            f"{tuple(ec.shape)} != {tuple(target_shape)} (different "
            "index?); refusing to restore")
    return table._replace(ec_count=torch.zeros(
        tuple(target_shape), dtype=torch.int32, device=ec.device))


def save_em_snapshot(path: str, alpha, iteration: int,
                     converged: bool = False) -> None:
    """An EM or bootstrap snapshot, uncompressed (it is written from the
    fixed point's host syncs, and compressing a config-scale (T, B) alpha
    costs seconds). ``converged`` marks the pin written after the EM
    stage, with which a resume skips the stage."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as fh:
        np.savez(fh, alpha=_host(alpha), iteration=np.int64(iteration),
                 converged=np.bool_(converged))
    os.replace(tmp, path)


def load_em_snapshot(path: str) -> Optional[Tuple[np.ndarray, int, bool]]:
    """(alpha, iteration, converged), or None when there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        converged = bool(z["converged"]) if "converged" in z.files else False
        return z["alpha"], int(z["iteration"]), converged


class StageSnapshots:
    """A run's EM and bootstrap snapshots beside its map checkpoint
    (``<checkpoint_path>.em.npz``, ``.boot.npz``), so one --checkpoint
    protects every stage; without a path they do nothing. Only the lead
    (rank 0) reads, writes and deletes them; ``from_rank0``, the mapper's
    broadcast (the identity on one card), gives every rank the lead's
    snapshot, so all take the same resume or skip decision. A snapshot of
    another shape than (T,) or (T, B) is ignored."""

    def __init__(self, checkpoint_path: Optional[str], T: int, B: int,
                 lead: bool, from_rank0: Callable):
        self.paths = ({"EM": checkpoint_path + ".em.npz",
                       "bootstrap": checkpoint_path + ".boot.npz"}
                      if checkpoint_path else {})
        self.shapes = {"EM": (T,), "bootstrap": (T, B)}
        self.lead, self.from_rank0 = lead, from_rank0

    def load(self, stage: str) -> Tuple[Optional[np.ndarray], int, bool]:
        """(alpha or None, iteration, converged) of the lead's snapshot of
        ``stage`` ("EM" or "bootstrap") on every rank; converged marks the
        pin after the EM stage, with which a resume skips EM."""
        path, shape = self.paths.get(stage), self.shapes[stage]
        if path is None:
            return None, 0, False
        got = load_em_snapshot(path) if self.lead else None
        if got is not None and got[0].shape != shape:
            log.warning("%s snapshot %s has shape %s != %s; ignoring",
                        stage, path, got[0].shape, shape)
            got = None
        elif got is not None:
            log.info("resuming %s from snapshot at iteration %d%s", stage,
                     got[1], " (converged: skipping EM)" if got[2] else "")
        alpha, it, conv = got if got is not None else (None, 0, False)
        meta = self.from_rank0(np.asarray([alpha is not None, it, conv],
                                          np.int64))
        if not meta[0]:
            return None, 0, False
        alpha = np.asarray(np.zeros(shape) if alpha is None else alpha,
                           np.float64)
        return self.from_rank0(alpha), int(meta[1]), bool(meta[2])

    def on_sync(self, stage: str) -> Optional[Callable]:
        """The lead's ``on_sync`` of ``stage``: it writes the snapshot at
        most once every ``SNAPSHOT_MIN_INTERVAL_S``. None elsewhere."""
        path = self.paths.get(stage) if self.lead else None
        if path is None:
            return None
        last = [float("-inf")]

        def on_sync(a, it):
            now = time.monotonic()
            if now - last[0] >= SNAPSHOT_MIN_INTERVAL_S:
                last[0] = now
                save_em_snapshot(path, a, it)

        return on_sync

    def pin(self, alpha, iteration: int, converged: bool) -> None:
        """The EM stage's end, unthrottled, so a crash in the bootstrap
        resumes with EM skipped; a stage capped by max_iters pins
        converged=False, so a resume under a raised budget goes on."""
        if self.lead and "EM" in self.paths:
            save_em_snapshot(self.paths["EM"], alpha, iteration, converged)

    def done(self) -> None:
        """A completed run's snapshots deleted: a later fresh run must not
        warm-start from them."""
        for p in self.paths.values() if self.lead else ():
            if os.path.exists(p):
                os.remove(p)
