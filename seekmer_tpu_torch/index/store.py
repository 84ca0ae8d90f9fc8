"""K-mer index container and its file format: the port's copy of
``seekmer_tpu/index/store.py``. An index file written by either package
loads in the other with equal arrays (``tests/test_torch_self_contained.py``).

The index is a set of flat arrays: a bucketized open-addressing main table,
a small stash table for keys whose home bucket was full, and CSR
equivalence-class membership. Table rows are int32[4] = [key_hi, key_lo,
ec_id, aux].
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np

EMPTY = np.int32(-1)  # key_hi sentinel for empty slots (valid hi >= 0)

FORMAT_VERSION = 2


@dataclasses.dataclass
class KMerIndex:
    """Flat-array k-mer -> equivalence-class index.

    Attributes:
      k: k-mer length.
      table: int32[S_main, 4] bucketized rows [key_hi, key_lo, ec_id, aux];
        EMPTY key_hi marks free slots. Buckets are ``bucket`` consecutive
        slots; a key lives ONLY in its home bucket
        (hash & (S_main/bucket - 1)) here, or its stash home bucket.
      main_slots: S_main (bucket-count is a power of two).
      stash: int32[S_stash, 4] same layout, independent hash; holds keys
        whose main home bucket was full.
      stash_slots: S_stash.
      bucket: slots per bucket (one device gather = one bucket).
      ec_offsets: int32[E + 1] CSR row pointers into ec_transcripts.
      ec_transcripts: int32[nnz] sorted transcript ids per EC.
      names: np.ndarray[str] transcript names, lengths: int32[T].
      genes: optional np.ndarray[str] per-transcript gene ids.
      fld_tid / fld_pos: optional int32[S_main + S_stash] per-slot payload
        for fragment-length estimation (map/fld.py): for slots holding a
        GLOBALLY UNIQUE k-mer (one occurrence in the whole transcriptome),
        the transcript id and the window's transcript-local position;
        -1 / 0 elsewhere. Stash slots follow main slots.
    """

    k: int
    table: np.ndarray
    main_slots: int
    stash: np.ndarray
    stash_slots: int
    bucket: int
    ec_offsets: np.ndarray
    ec_transcripts: np.ndarray
    names: np.ndarray
    lengths: np.ndarray
    genes: Optional[np.ndarray] = None
    fld_tid: Optional[np.ndarray] = None
    fld_pos: Optional[np.ndarray] = None

    @property
    def num_transcripts(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def num_ecs(self) -> int:
        return int(self.ec_offsets.shape[0] - 1)

    @property
    def num_kmers(self) -> int:
        return int((self.table[:, 0] != EMPTY).sum() + (self.stash[:, 0] != EMPTY).sum())

    def ec_members(self, ec_id: int) -> np.ndarray:
        s, e = self.ec_offsets[ec_id], self.ec_offsets[ec_id + 1]
        return self.ec_transcripts[s:e]

    def meta(self) -> Dict[str, Any]:
        return {
            "format_version": FORMAT_VERSION,
            "k": self.k,
            "main_slots": self.main_slots,
            "stash_slots": self.stash_slots,
            "bucket": self.bucket,
        }

    def save(self, path: str) -> None:
        meta = np.frombuffer(json.dumps(self.meta()).encode(), dtype=np.uint8)
        arrays = dict(
            meta=meta,
            table=self.table,
            stash=self.stash,
            ec_offsets=self.ec_offsets,
            ec_transcripts=self.ec_transcripts,
            names=self.names.astype("S"),
            lengths=self.lengths,
        )
        if self.genes is not None:
            arrays["genes"] = self.genes.astype("S")
        if self.fld_tid is not None:
            arrays["fld_tid"] = self.fld_tid
            arrays["fld_pos"] = self.fld_pos
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str) -> "KMerIndex":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta["format_version"] != FORMAT_VERSION:
                raise ValueError(f"index format {meta['format_version']} != {FORMAT_VERSION}")
            genes = z["genes"].astype(str) if "genes" in z.files else None
            return cls(
                k=int(meta["k"]),
                table=z["table"],
                main_slots=int(meta["main_slots"]),
                stash=z["stash"],
                stash_slots=int(meta["stash_slots"]),
                bucket=int(meta["bucket"]),
                ec_offsets=z["ec_offsets"],
                ec_transcripts=z["ec_transcripts"],
                names=z["names"].astype(str),
                lengths=z["lengths"],
                genes=genes,
                fld_tid=z["fld_tid"] if "fld_tid" in z.files else None,
                fld_pos=z["fld_pos"] if "fld_pos" in z.files else None,
            )
