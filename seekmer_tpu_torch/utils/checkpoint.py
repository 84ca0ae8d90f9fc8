"""Batch-granular checkpoints and EM snapshots: the port's copy of
``seekmer_tpu/utils/checkpoint.py``, single process.

- A map checkpoint holds the signature table and the read stream's resume
  cursor: each stream's file index and uncompressed byte offset plus the
  rows of the partial buckets (``io/fastq.CheckpointableBatchSource``), or
  a pack-cache cursor (``io/pack_cache.PackCacheSource``). It is written
  every N batches; a resume seeks instead of re-decoding.
- An EM snapshot holds the iterate (alpha) and the iteration count, so a
  run restarts at every stage boundary and inside EM and the bootstrap.

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
import os
from typing import Optional, Tuple

import numpy as np
import torch

# 2: SigTable.key became bucketized (S/KB+1, KB, 2).
# 3: the stream cursor became offset-based (file index + byte offset +
#    pending partial-bucket rows); format-2 checkpoints are rejected.
FORMAT = 3

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
