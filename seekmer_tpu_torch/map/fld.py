"""Fragment-length distribution (FLD) estimation from mapped read pairs;
counterpart of ``seekmer_tpu/map/fld.py``, single device.

The index carries, for every globally unique k-mer of the main table, its
transcript id and transcript-local window position (``KMerIndex.fld_tid``
/ ``fld_pos``). For a read pair, a few window offsets per mate are looked
up in the main table; the first offset per mate that hits a unique k-mer
pins the mate, and two mates pinned to the same transcript give

    f = |q1 - q2| + k + o1 + o2

Observations go into an integer histogram on the device with
``index_add_``, which is exact in any order; the host reads it once, in
``estimate``. Sampling runs on the first ``SAMPLE_BATCHES`` paired batches
only. The estimator's settings are those of the JAX package's defaults, as
constants: nothing in the port varies them.

Each mate's windows are packed by K1 (``pack_cuda.pack_canonical_2bit``)
on the 2-bit batch, as the map step packs them. ``_match_slot`` was XLA in
JAX and stays plain torch: a row gather plus a compare. The prefix-sharded
estimator (``for_prefix_shard0``) waits for the multi-GPU port
(ROADMAP.md, still to port, "Multi-GPU").
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..index.store import KMerIndex
from ..io.fastq import pack_batch_2bit
from ..ops import pack_cuda
from ..ops.hash import hash_kmer

# The settings of ``seekmer_tpu.map.fld``'s single-device estimator: the
# window offsets sampled per mate, the longest fragment kept, the number of
# paired batches sampled and the fewest observations for an estimate.
DEFAULT_OFFSETS = (0, 7, 15, 23)
MAX_LEN = 1024
SAMPLE_BATCHES = 4
MIN_SAMPLES = 100


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Per row, the column of the first True (0 when there is none), as
    ``jnp.argmax`` of a bool row gives it."""
    W = mask.shape[1]
    col = torch.arange(W, device=mask.device).expand_as(mask)
    first = torch.where(mask, col, W).amin(dim=1)
    return torch.where(first == W, 0, first)


def _match_slot(hi, lo, table, slots: int, bucket: int):
    """Flat (hi, lo) lanes -> main-table slot id of the matching key (-1
    when absent): the bucket gather and slab compare of the lookup, but
    returning the slot, which addresses the per-slot FLD payload."""
    G = bucket
    hb = hash_kmer(hi, lo) & (slots // G - 1)
    rows = table[hb]  # (N, 4G) slab layout
    match = (rows[:, :G] == hi[:, None]) & (rows[:, G:2 * G] == lo[:, None])
    return torch.where(match.any(dim=1), hb * G + _first_true(match), -1)


def _first_unique(tid, qpos, offs):
    """Per read, the first sampled offset whose k-mer is globally unique.
    tid/qpos [B, W], offs [W]; returns (t, q, o, usable)."""
    has = tid >= 0
    j = _first_true(has)
    b = torch.arange(tid.shape[0], device=tid.device)
    return tid[b, j], qpos[b, j], offs[j], has.any(dim=1)


def fld_step(table, fld_tid, fld_pos, hist, packed, bad, lengths, packed2,
             bad2, lengths2, pad_len: int, k: int, main_slots: int,
             bucket: int):
    """One FLD sampling step over a 2-bit packed paired batch (``pad_len``
    is the unpacked padded length); adds to ``hist`` (int32[max_len + 1],
    index 0 the reject dump) in place and returns it. Fragments shorter
    than the longer mate are rejected, as in the JAX package and the
    oracle."""
    max_len = hist.shape[0] - 1

    def mate(packed, bad, lengths):
        hi, lo, valid = pack_cuda.pack_canonical_2bit(packed, bad, lengths,
                                                      pad_len, k)
        P = hi.shape[1]
        w = torch.tensor([o for o in DEFAULT_OFFSETS if o < P] or [0],
                         device=hi.device)
        his, los, vs = hi[:, w], lo[:, w], valid[:, w]
        B, W = his.shape
        slot = _match_slot(his.reshape(-1), los.reshape(-1), table,
                           main_slots, bucket)
        ok = vs.reshape(-1) & (slot >= 0)
        si = slot.clamp(min=0)
        tid = torch.where(ok, fld_tid[si], -1).reshape(B, W)
        qp = torch.where(ok, fld_pos[si], 0).reshape(B, W)
        return _first_unique(tid, qp, w)

    t1, q1, o1, u1 = mate(packed, bad, lengths)
    t2, q2, o2, u2 = mate(packed2, bad2, lengths2)
    f = (q1 - q2).abs().to(torch.int64) + k + o1 + o2
    minf = torch.maximum(lengths, lengths2).to(torch.int64)
    ok = u1 & u2 & (t1 == t2) & (f >= minf) & (f <= max_len)
    return hist.index_add_(0, torch.where(ok, f, 0), ok.to(hist.dtype))


class FLDEstimator:
    """Accumulates a fragment-length histogram over the first
    ``SAMPLE_BATCHES`` paired batches; ``estimate()`` reads it back once.

    ``device_index`` (``map.driver.DeviceIndex``) shares the mapper's main
    table on its device; the FLD payload (two int32 per main slot) is the
    only extra upload, dropped after the sampling batches.
    """

    def __init__(self, index: KMerIndex, device_index):
        if index.fld_tid is None:
            raise ValueError("index has no FLD payload "
                             "(built with fld_positions=False)")
        self.k = index.k
        self.main_slots = index.main_slots
        self.bucket = index.bucket
        self.device_index = device_index
        self.device = device_index.table.device
        # main-table part only: stash-resident k-mers are never sampled
        self.fld_tid = torch.from_numpy(
            np.ascontiguousarray(index.fld_tid[:index.main_slots])).to(
                self.device)
        self.fld_pos = torch.from_numpy(
            np.ascontiguousarray(index.fld_pos[:index.main_slots])).to(
                self.device)
        self.hist = torch.zeros(MAX_LEN + 1, dtype=torch.int32,
                                device=self.device)
        self._fed = 0

    @property
    def active(self) -> bool:
        return self._fed < SAMPLE_BATCHES

    def feed(self, batch) -> None:
        """Sample a paired ReadBatch (no-op once enough batches are fed).
        Host batches are 2-bit packed and uploaded first."""
        from .driver import to_device

        if not self.active or batch.codes2 is None:
            return
        if batch.pad_len is None:
            batch = pack_batch_2bit(batch)
        u = lambda a: to_device(a, self.device)  # noqa: E731
        fld_step(self.device_index.table, self.fld_tid, self.fld_pos,
                 self.hist, u(batch.codes), u(batch.bad), u(batch.lengths),
                 u(batch.codes2), u(batch.bad2), u(batch.lengths2),
                 batch.pad_len, self.k, self.main_slots, self.bucket)
        self._fed += 1
        if not self.active:  # free the payload once sampling is done
            self.fld_tid = self.fld_pos = None

    def estimate(self) -> Optional[Tuple[float, float, int]]:
        """(mean, sd, n_samples), or None if too few observations."""
        hist = self.hist.cpu().numpy().copy()
        hist[0] = 0  # reject dump
        n = int(hist.sum())
        if n < MIN_SAMPLES:
            return None
        f = np.arange(hist.size, dtype=np.float64)
        mean = float((f * hist).sum() / n)
        var = float(((f - mean) ** 2 * hist).sum() / max(n - 1, 1))
        return mean, float(np.sqrt(var)), n
