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
the other. Two additions, which the JAX package ignores: a pack-cache
cursor's build id (``"build"``) in the cursor's metadata, and the
fragment-length estimator's state (``fld_hist`` and the metadata's
``fld_fed``), so that a resumed paired run estimates the FLD from the
batches the uninterrupted run sampled. Left out: the host-cursor
sidecars of multi-process checkpoints (``save_host_cursor``,
``load_host_cursor``), which wait for the port's multi-GPU mapper.
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


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _cursor_to_arrays(stream_state: Optional[dict]):
    """A cursor -> (json-able metadata, npz arrays of its pending rows)."""
    if stream_state is None:
        return None, {}
    cursor_meta = {k: stream_state[k] for k in _CURSOR_KEYS}
    if "build" in stream_state:
        cursor_meta["build"] = stream_state["build"]
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
    if "build" in cm:
        cursor["build"] = cm["build"]
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
            **arrays,
        )
    os.replace(tmp, path)


def load_map_checkpoint(path: str, device="cuda"):
    """(SigTable on ``device``, total_reads, cursor, fld), or None when
    there is no file; ``fld`` is the FLD estimator's (histogram, batches
    fed), None in a file without it (the JAX package's). Raises on another
    format and on a multi-process save (its read counts live in per-host
    files the port does not read yet)."""
    from ..map.signature import sig_table_from_numpy

    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["format"] != FORMAT:
            raise ValueError(f"checkpoint format {meta['format']} != {FORMAT}")
        if meta["total_reads"] < 0:
            raise ValueError(
                f"checkpoint {path} was written by a multi-process run; "
                "a single-process run cannot restore it")
        fields = {name: z[name] for name in ("key", "count", "sig",
                                              "overflow")}
        # absent in older format-3 files: zeros of overflow's shape, and
        # the (1,) placeholder of the per-EC vector (adapt_ec_count)
        fields["collisions"] = (z["collisions"] if "collisions" in z.files
                                else np.zeros_like(z["overflow"]))
        fields["ec_count"] = (z["ec_count"] if "ec_count" in z.files
                              else np.zeros(1, np.int32))
        cursor = _cursor_from_npz(z, meta["cursor"])
        fld = ((z["fld_hist"], meta["fld_fed"]) if "fld_hist" in z.files
               else None)
    return (sig_table_from_numpy(fields, device), meta["total_reads"],
            cursor, fld)


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
