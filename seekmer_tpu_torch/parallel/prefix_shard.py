"""The prefix-sharded k-mer index with all_to_all read routing (BASELINE
config 4); counterpart of ``seekmer_tpu/parallel/prefix_shard.py``.

The k-mer table is cut into D = ``index_axis`` shards by the top log2(D)
bits of the main-table slot hash, so each card holds 1/D of it; the low
bits still address the home bucket within the owner's shard.

The JAX package runs one ``shard_map`` step over a (reads, index) device
mesh. Here a rank drives one card (``comm.py``) and the mesh is a layout
of the ranks: world = ``data_axis`` x ``index_axis``, rank r at data row
r // n_index and index column r % n_index, holding prefix shard
r % n_index and only that one on its card. The ranks of a data row form an
index group (``comm.index_groups``), within which lookups are routed.
Every rank reads every global batch of the input it shares and maps rows
[r B/n, (r+1) B/n) of it (n ranks sharing the input, r its place among
them), as the JAX package cuts each global batch over both mesh axes
(``_put_batch``): every rank runs the same number of steps, and each
owner gets the lanes the JAX device r sends it. (``io/fastq.
rank_batches``, which deals whole batches, would leave a rank out of a
short last round's all_to_all.)

A dense step, each rank on its rows: K1 packs both mates into one (B,
2P) row; ``routed_lookup`` finds every window's EC on its owner's shard;
K3 makes the signatures and A1 folds them into this rank's own table.
``routed_lookup`` (JAX ``:183-264``):

  1. R1 (``ops/route_cuda.route_first``), one pass: each lane's owner,
     its rank among the lanes of its owner, the per-owner counts, round
     0's (D, K) send slab of the lanes ranked below K and a spill list of
     the others. It replaces the JAX ``lax.sort`` by owner, the
     associative-scan rank and the scatter: the kernel ranks by atomic
     counters, so the order within an owner, and which lanes spill, vary
     from run to run, but the ECs and the rounds depend only on the
     counts;
  2. one all-gather of the counts over the index group, read on the host:
     the largest count M gives every rank of the group the same number of
     rounds, ceil(M / K) with K = ceil(lanes / n_index * capacity_factor)
     (the JAX ``psum``-agreed ``while_loop`` condition, read once here
     instead of a device-side loop), and tells each owner how many of the
     slots it receives are filled, so no valid bytes cross;
  3. a round: round 0 takes R1's slab; a later round j's slab holds the
     spilled lanes ranked in [jK, (j+1)K) (``route_cuda.route_spill``,
     over the spill list alone, sized on the host from this rank's row of
     the counts: sum_d max(counts[d] - K, 0)); two all_to_alls carry their
     hi and lo to the owners; K2 (``probe_cuda.lookup_ecs``, unchanged)
     looks them up on the owner's shard; one all_to_all carries the ECs
     back; R2 (``route_cuda.unroute``) writes them to their lanes. Lanes
     past the capacity drain in later rounds, so routing is exact and
     ``extra_rounds`` = rounds - 1 measures capacity pressure only.

Sampled routing (``probe_sample`` >= 2, JAX ``:381-415`` over
``ops/probe.two_phase_signatures`` with ``lookup_fn``/``residual_agree``):
K5 probes a whole local table inside its kernel, so the fast path is cut
here. Phase 1: K1 packs, the sampled columns (``probe.sample_columns``)
go through ``routed_lookup``, and ``probe.classify_samples`` (the
classify step, torch ops on the card) picks the units to re-probe. Phase
2: the units through K1, ``routed_lookup`` and K3, then K6 merges. The
units differ in number from rank to rank, so phase 2's K is agreed first
by an all-reduce (max) of the unit counts over the index group, and a
rank with no unit still takes part in every round. The JAX fallback cap
(``sample_fallback_frac or 0.125``) only sized its capped residual rounds
and is dropped, as in the one-card fast mode: every unit goes in one
routed lookup. As in the JAX package, this mode does not track extra
routing rounds (0). With ``probe_stride`` > 1 or ``fusion_pairs`` the JAX
package runs the dense routed lookup with union signatures of width C,
and so does the port (not K7, not per-mate signatures).

``finalize`` merges every rank's table (``data_parallel.RankMapper``'s
gather), and ``extra_routing_rounds`` is the largest over the ranks. The FLD is
estimated against prefix shard 0 (``map/fld.FLDEstimator.
for_prefix_shard0``), each rank on its rows, the histograms summed.
Checkpoints are the multi-process protocol of ``ckpt_mp.py``; the ranks
read the same batches, so every sidecar holds the one global cursor.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import MapConfig, ShardConfig
from ..index.build import _next_pow2, build_bucket_table
from ..index.store import EMPTY, KMerIndex
from ..io.fastq import ReadBatch
from ..map.driver import audit_this_batch, to_device, upload_ec_csr
from ..map.fld import SAMPLE_BATCHES, FLDEstimator
from ..map.signature import SigTable, make_sig_table
from ..ops import (accumulate_cuda, fast_cuda, pack_cuda, probe_cuda,
                   route_cuda, sig_cuda)
from ..ops.hash import hash_kmer_np, hash_kmer_stash_np
from ..ops.probe import classify_samples, device_table_layout, sample_columns
from ..ops.route import filled, owner_bits
from . import comm
from ..utils.metrics import Metrics
from .data_parallel import RankMapper

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PrefixShards:
    """Every prefix shard's tables in the slab layout, on the host."""

    # D x int32[n_buckets, 4 * bucket]; None for a shard not built
    table: List[Optional[np.ndarray]]
    stash: List[Optional[np.ndarray]]  # D x int32[n_stash_buckets, 4 * G]
    main_slots: int
    stash_slots: int
    bucket: int
    k: int
    n_shards: int


@dataclasses.dataclass
class ShardedDeviceIndex:
    """This rank's prefix shard on its device."""

    table: torch.Tensor  # int32[n_buckets, 4 * bucket]
    stash: torch.Tensor
    main_slots: int
    stash_slots: int
    bucket: int
    k: int
    n_shards: int

    @classmethod
    def from_shards(cls, shards: PrefixShards, d: int,
                    device) -> "ShardedDeviceIndex":
        def put(a):
            return torch.from_numpy(a).to(device)

        return cls(put(shards.table[d]), put(shards.stash[d]),
                   shards.main_slots, shards.stash_slots, shards.bucket,
                   shards.k, shards.n_shards)


def _occupied_keys(table: np.ndarray):
    occ = table[:, 0] != EMPTY
    return table[occ, 0], table[occ, 1], table[occ, 2], table[occ, 3]


def _overflow(hi, lo, n_buckets: int, G: int) -> np.ndarray:
    """The overflow mask ``build_bucket_table`` gives these keys, without
    building the table: only the keys of overfull buckets are sorted."""
    homes = (hash_kmer_np(hi.view(np.uint32), lo.view(np.uint32))
             & np.uint32(n_buckets - 1)).astype(np.int64)
    over = np.zeros(hi.size, bool)
    idx = np.flatnonzero(np.bincount(homes, minlength=n_buckets)[homes] > G)
    if idx.size:
        order = idx[np.argsort(homes[idx], kind="stable")]
        hs = homes[order]
        pos = np.arange(hs.size)
        first = np.ones(hs.size, bool)
        first[1:] = hs[1:] != hs[:-1]
        rank = pos - np.maximum.accumulate(np.where(first, pos, 0))
        over[order[rank >= G]] = True
    return over


def shard_index_by_prefix(index: KMerIndex, n_shards: int,
                          load_factor: float = 0.5,
                          return_fld_shard0: bool = False,
                          only: Optional[Iterable[int]] = None):
    """The flat index rebuilt as ``n_shards`` prefix-partitioned tables,
    byte-equal to the JAX package's: the owner of a key is the top
    log2(n_shards) bits of its main slot hash; every shard has the
    bucket count of the fullest and one stash size, grown until no stash
    bucket overflows (earlier shards' stashes rebuilt if it grew).

    ``only`` names the shards whose tables are built (the others are None;
    only their overflow is found, for the stash size): a rank needs its
    own. ``return_fld_shard0`` also returns (table0, fld_tid0, fld_pos0):
    shard 0's main table in the slab layout and its per-slot FLD payload
    (main-table keys only; stash keys are never sampled), and so builds
    shard 0."""
    b = owner_bits(n_shards)
    keep = set(range(n_shards) if only is None else only)
    if return_fld_shard0:
        keep.add(0)
    hi1, lo1, v1, a1 = _occupied_keys(index.table)
    hi2, lo2, v2, a2 = _occupied_keys(index.stash)
    hi = np.concatenate([hi1, hi2])
    lo = np.concatenate([lo1, lo2])
    val = np.concatenate([v1, v2])
    aux = np.concatenate([a1, a2])
    G = index.bucket
    h = hash_kmer_np(hi.view(np.uint32), lo.view(np.uint32))
    owner = ((h >> np.uint32(32 - b)).astype(np.int64) if b
             else np.zeros(hi.size, np.int64))
    masks = [owner == d for d in range(n_shards)]
    max_n = max(int(m.sum()) for m in masks) if hi.size else 1
    n_buckets = _next_pow2(max(int(np.ceil(max_n / (load_factor * G))), 2))

    mains, overs = {}, []
    for d, m in enumerate(masks):
        if d in keep:
            mains[d] = build_bucket_table(hi[m], lo[m], val[m], n_buckets, G,
                                          hash_kmer_np, aux=aux[m],
                                          return_placement=True)
            overs.append(mains[d][1])
        else:
            overs.append(_overflow(hi[m], lo[m], n_buckets, G))

    def stash_of(d, stash_buckets):
        m, over = masks[d], overs[d]
        while True:
            st, s_over = build_bucket_table(
                hi[m][over], lo[m][over], val[m][over], stash_buckets, G,
                hash_kmer_stash_np, aux=aux[m][over])
            if not s_over.any():
                return st, stash_buckets
            stash_buckets *= 2

    stashes = []
    stash_buckets = _next_pow2(max(1024 // G, 2))
    for d in range(n_shards):
        st, stash_buckets = stash_of(d, stash_buckets)
        stashes.append(st)
    for d in range(n_shards):  # the stash grew after shard d's was built
        if stashes[d].shape[0] != stash_buckets * G:
            stashes[d], _ = stash_of(d, stash_buckets)
    log.info("prefix shards: %s keys a shard, %d buckets each",
             [int(m.sum()) for m in masks], n_buckets)

    shards = PrefixShards(
        table=[device_table_layout(mains[d][0], G) if d in mains else None
               for d in range(n_shards)],
        stash=[device_table_layout(stashes[d], G) if d in mains else None
               for d in range(n_shards)],
        main_slots=n_buckets * G, stash_slots=stash_buckets * G, bucket=G,
        k=index.k, n_shards=n_shards)
    if not return_fld_shard0:
        return shards
    if index.fld_tid is None:
        raise ValueError("index has no FLD payload")
    occ1 = index.table[:, 0] != EMPTY
    occ2 = index.stash[:, 0] != EMPTY
    S1 = index.main_slots
    key_tid = np.concatenate([index.fld_tid[:S1][occ1],
                              index.fld_tid[S1:][occ2]])
    key_pos = np.concatenate([index.fld_pos[:S1][occ1],
                              index.fld_pos[S1:][occ2]])
    # shard 0's placement: slot0[i] holds its key src0[i]
    _, _, slot0, src0 = mains[0]
    idx0 = np.flatnonzero(masks[0])[src0]
    fld_tid0 = np.full(n_buckets * G, -1, np.int32)
    fld_pos0 = np.zeros(n_buckets * G, np.int32)
    fld_tid0[slot0] = key_tid[idx0]
    fld_pos0[slot0] = key_pos[idx0]
    return shards, (shards.table[0], fld_tid0, fld_pos0)


def capacity(lanes: int, n_index: int, capacity_factor: float) -> int:
    """Lanes an owner takes from a rank in one round, as the JAX package
    sizes its (D, K) slab (``prefix_shard.py:354``)."""
    return int(np.ceil(lanes / n_index * capacity_factor))


def routed_lookup(hi, lo, valid, sdi: ShardedDeviceIndex, group,
                  capacity: int) -> Tuple[torch.Tensor, int]:
    """EC ids of (hi, lo, valid) lanes of any shape, each looked up on its
    owner's shard in ``group`` (this rank's index group), at most
    ``capacity`` lanes from a rank to an owner a round. Collective: every
    rank of the group calls it with the same capacity. Returns (ecs
    int32, shaped as hi; extra_rounds, the rounds past the first)."""
    D = sdi.n_shards
    if comm.world(group) != D:
        raise ValueError(f"{D} shards over an index group of "
                         f"{comm.world(group)} ranks")
    shape = hi.shape
    hi_f, lo_f, v_f = hi.reshape(-1), lo.reshape(-1), valid.reshape(-1)
    send_hi, send_lo, ret, counts, spill = route_cuda.route_first(
        hi_f, lo_f, v_f, D, capacity)
    # [source, owner] lanes of the whole group
    every = comm.allgather(counts, group).cpu().numpy().astype(np.int64)
    most = int(every.max()) if every.size else 0
    if most and capacity < 1:
        raise ValueError(f"routing capacity {capacity} for {most} lanes")
    rounds = -(-most // capacity) if most else 0
    me = comm.rank(group)
    incoming = torch.as_tensor(every[:, me], device=hi.device)
    spilled = int(np.maximum(every[me] - capacity, 0).sum())
    ecs = torch.full((hi_f.numel(),), -1, dtype=torch.int32,
                     device=hi.device)
    for j in range(rounds):
        base = j * capacity
        if j:
            send_hi, send_lo, ret = route_cuda.route_spill(
                hi_f, lo_f, spill, spilled, D, base, capacity)
        q_hi = comm.all_to_all(send_hi, group)
        q_lo = comm.all_to_all(send_lo, group)
        ec_q = probe_cuda.lookup_ecs(q_hi, q_lo,
                                     filled(incoming, base, capacity),
                                     sdi.table, sdi.main_slots, sdi.stash,
                                     sdi.stash_slots, sdi.bucket)
        route_cuda.unroute(comm.all_to_all(ec_q, group), ret, counts, base,
                           capacity, ecs)
    return ecs.reshape(shape), max(rounds - 1, 0)


def prefix_ranks(shard: ShardConfig) -> int:
    """The ranks ``shard`` lays out as data rows of ``index_axis`` (a
    ``data_axis`` of 0 or -1: as many rows as the group holds); it must
    be the group's size."""
    n = comm.world()
    rows = shard.data_axis if shard.data_axis > 0 else n // shard.index_axis
    if rows * shard.index_axis != n:
        raise ValueError(f"ShardConfig data_axis {shard.data_axis} x "
                         f"index_axis {shard.index_axis} needs "
                         f"{rows * shard.index_axis} ranks; the process "
                         f"group has {n}")
    return n


def _rows(batch: ReadBatch, a: int, z: int) -> ReadBatch:
    """Rows [a, z) of a host batch, its cursor kept."""
    def cut(x):
        return None if x is None else x[a:z]

    return dataclasses.replace(
        batch, codes=cut(batch.codes), lengths=cut(batch.lengths),
        weights=cut(batch.weights), codes2=cut(batch.codes2),
        lengths2=cut(batch.lengths2), bad=cut(batch.bad),
        bad2=cut(batch.bad2), n_real_cached=None)


class PrefixShardedMapper(RankMapper):
    """A rank's mapper under the prefix-sharded index: its rows of every
    global batch, its lookups routed to their owners over its index group,
    its own signature table, merged with every rank's at ``finalize``.

    ``input_share``: (this rank's place, the number of ranks) among those
    given the same input, which split each of its batches by rows; None:
    every rank of the group reads the whole input (one host). Ranks that
    share an input must hold whole index groups."""

    counts_complex = False  # K3 runs without a counter here

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 shard: ShardConfig = ShardConfig(index_mode="prefix"),
                 device="cuda", capacity_factor: float = 2.0,
                 input_share: Optional[Tuple[int, int]] = None,
                 metrics: Optional[Metrics] = None,
                 estimate_fld: bool = False):
        self.n_ranks = prefix_ranks(shard)
        self.n_index = shard.index_axis
        self.rank = comm.rank()
        self.column = self.rank % self.n_index
        self.place, self.sharers = (input_share if input_share is not None
                                    else (self.rank, self.n_ranks))
        if self.sharers % self.n_index or (self.rank - self.place) % \
                self.n_index:
            raise ValueError(f"{self.sharers} ranks share an input from "
                             f"rank {self.rank - self.place}: not whole "
                             f"index groups of {self.n_index}")
        if cfg.batch_size % self.sharers:
            raise ValueError(f"batch {cfg.batch_size} not divisible by "
                             f"{self.sharers} ranks")
        self.capacity_factor = capacity_factor
        self.group = comm.index_groups(self.n_index)
        super().__init__(index, cfg, device=device, metrics=metrics,
                         estimate_fld=estimate_fld)
        # the ranks build shards of different cost: start mapping together,
        # so a map stage's wall holds no other rank's build
        comm.barrier()

    def _upload_index(self):
        """This rank's prefix shard on its card (and shard 0's main table
        and FLD payload on the host, for ``make_fld_estimator``)."""
        index = self.index
        built = shard_index_by_prefix(
            index, self.n_index, return_fld_shard0=index.fld_tid is not None,
            only=[self.column])
        shards, self._fld_shard0 = (built if index.fld_tid is not None
                                    else (built, None))
        self.sdi = ShardedDeviceIndex.from_shards(shards, self.column,
                                                  self.device)
        return upload_ec_csr(index, self.device)

    def _new_table(self) -> SigTable:
        return make_sig_table(
            self.cfg.sig_table_bits, self.cfg.max_ecs_per_read,
            num_ecs=0 if self.cfg.fusion_pairs else self.index.num_ecs,
            device=self.device)

    def _reset(self) -> None:
        super()._reset()
        self._rounds_max = 0
        self.extra_routing_rounds = 0  # over every rank, set by finalize

    def select(self, batches: Iterable[ReadBatch]) -> Iterator[ReadBatch]:
        """This rank's rows of every batch of the stream it reads."""
        for b in batches:
            n = b.codes.shape[0]
            if n % self.sharers:
                raise ValueError(f"a batch of {n} rows does not split over "
                                 f"{self.sharers} ranks")
            step = n // self.sharers
            yield _rows(b, self.place * step, (self.place + 1) * step)

    def make_fld_estimator(self, state=None):
        """An estimator over prefix shard 0 (this rank's own shard on
        column 0, else a copy of its main table), sampling this rank's
        rows of the first SAMPLE_BATCHES paired batches."""
        if self._fld_shard0 is None:
            return None
        table0, fld_tid0, fld_pos0 = self._fld_shard0
        t0 = (self.sdi.table if self.column == 0
              else torch.from_numpy(table0).to(self.device))
        self.fld = FLDEstimator.for_prefix_shard0(
            self.index, t0, fld_tid0, fld_pos0, self.n_index, state,
            sample_batches=SAMPLE_BATCHES)
        return self.fld

    def _fold(self, batch: ReadBatch) -> None:
        def u(x):
            return to_device(x, self.device)
        mates = [(u(batch.codes), u(batch.bad), u(batch.lengths))]
        if batch.codes2 is not None:
            mates.append((u(batch.codes2), u(batch.bad2),
                          u(batch.lengths2)))
        sig, mapped, extra = self._signatures(mates, batch.pad_len)
        self.table = accumulate_cuda.fold_batch(
            self.table, sig, mapped, weights=u(batch.weights),
            sig_probe=self.cfg.sig_probe,
            audit=audit_this_batch(self.cfg, self._fed_batches))
        self._rounds_max = max(self._rounds_max, extra)

    def _signatures(self, mates, L: int):
        """(sig, mapped, extra rounds) of this rank's rows."""
        cfg = self.cfg
        C = cfg.max_ecs_per_read
        hi, lo, valid = pack_cuda.pack_mates(mates, L, self.sdi.k)
        if (cfg.probe_sample >= 2 and cfg.probe_stride <= 1
                and not cfg.fusion_pairs):
            sig, mapped = self._sampled(mates, L, hi, lo, valid)
            return sig, mapped, 0
        K = capacity(hi.numel(), self.n_index, self.capacity_factor)
        ecs, extra = routed_lookup(hi, lo, valid, self.sdi, self.group, K)
        sig, mapped = sig_cuda.read_signatures(ecs, valid, C)
        return sig, mapped, extra

    def _sampled(self, mates, L: int, hi, lo, valid):
        """Sampled routing: phase 1 on the sampled windows, the classify
        step, phase 2 on the units it picks, the merge (K6)."""
        cfg, k, cf = self.cfg, self.sdi.k, self.capacity_factor
        C = cfg.max_ecs_per_read
        B, n_seg = hi.shape[0], len(mates)
        P = max(L - k + 1, 0)
        cols = sample_columns(P, cfg.probe_sample)
        at = torch.tensor([g * P + c for g in range(n_seg) for c in cols],
                          device=hi.device)
        h1, l1, v1 = hi[:, at], lo[:, at], valid[:, at]
        ec_s, _ = routed_lookup(h1, l1, v1, self.sdi, self.group,
                                capacity(h1.numel(), self.n_index, cf))
        single, slot, units = classify_samples(
            ec_s.reshape(B, n_seg, len(cols)),
            valid.reshape(B, n_seg, P).any(dim=2), mates)
        nu = units[0].shape[0]
        most = int(comm.allreduce(np.asarray([nu], np.int64), "max",
                                  self.group)[0])
        sig_d = torch.empty((0, C), dtype=torch.int32, device=hi.device)
        mapped_d = torch.empty(0, dtype=torch.bool, device=hi.device)
        if most:
            if nu:
                h2, l2, v2 = pack_cuda.pack_canonical_2bit(*units, L, k)
            else:
                h2 = l2 = torch.empty((0, P), dtype=torch.int32,
                                      device=hi.device)
                v2 = torch.empty((0, P), dtype=torch.bool, device=hi.device)
            ecs, _ = routed_lookup(h2, l2, v2, self.sdi, self.group,
                                   capacity(most * P, self.n_index, cf))
            if nu:
                sig_d, mapped_d = sig_cuda.read_signatures(ecs, v2, C)
        return fast_cuda.merge_staging(single, slot, sig_d, mapped_d, C)

    def finalize(self):
        self.extra_routing_rounds = int(comm.allreduce(
            np.asarray([self._rounds_max], np.int64), "max")[0])
        if self.extra_routing_rounds:
            log.info("all_to_all capacity pressure: up to %d extra routing "
                     "round(s) a batch (results exact; raise "
                     "capacity_factor to trade memory for latency)",
                     self.extra_routing_rounds)
        return super().finalize()
