"""Single-device mapping driver: read batches -> map step -> signature
table -> merged signature counts. Counterpart of
``seekmer_tpu/map/driver.py``, dense and fast mode.

A dense map step is pack (K1) -> lookup with the stash (K2) -> signatures
(K3) -> accumulate (A1), each a kernel on a CUDA device and its plain
PyTorch version on the CPU. A fast one (``MapConfig.probe_sample`` >= 2)
is sample + probe + classify (K5) -> K1, K2 and K3 on the segments that
need a dense re-probe -> merge (K6) -> A1 (``ops/fast_cuda.py``). The
table stays on the device across batches; the host only streams, packs
and uploads reads, and merges and resolves the distinct signatures once
at the end.

Fast mode has no fallback cap here: every needy segment is re-probed in
one pass, so ``MapConfig.sample_fallback_frac`` is validated by the config
and ignored, and the JAX package's cap calibration
(``_pick_fallback_frac``, ``FALLBACK_FRAC_GRID``,
``Mapper._resolve_fallback_frac``, an extra classify-stage program on the
first batch) and its ``_probe_stage`` bisect hook have no counterpart.

``MapConfig.pack_backend``, ``probe_backend`` and ``sig_backend`` choose
between XLA and Pallas in the JAX package and are ignored here: which
implementation runs is decided by the device of the tensors alone. The
port always ships reads 2-bit packed, so ``h2d_pack_2bit`` is ignored too.
``_auto_probe_chunks`` and ``probe_chunks`` have no counterpart: the
lookup kernel never materialises the gathered bucket rows they bounded.

``merge_sig_rows``, ``MapResult``, ``audit_this_batch``,
``resolve_signatures`` and ``_group_member_lists`` are pure numpy copies
from ``seekmer_tpu/map/driver.py``, whose module imports JAX at the top.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, List, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch, pack_batch_2bit
from ..ops import (accumulate_cuda, fast_cuda, pack_cuda, probe_cuda,
                   sig_cuda)
from ..ops.probe import device_table_layout
from .signature import SIG_PAD, SigTable, make_sig_table, table_to_host

log = logging.getLogger(__name__)


def check_device(device) -> torch.device:
    """The device a caller asked for; raises when it is CUDA and no card is
    present, rather than carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} was requested but CUDA is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(x, device: torch.device):
    """A batch array as a tensor on ``device``: numpy arrays are uploaded,
    tensors must already be there; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"batch tensor on {x.device}, expected "
                             f"{device}")
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def check_map_config(cfg: MapConfig) -> None:
    """Raise on the mapping modes this port does not have yet."""
    if cfg.probe_stride > 1:
        raise NotImplementedError(
            "probe_stride > 1 (strided mode) is not ported yet: ROADMAP.md, "
            "still to port, 'Strided mode'")
    if cfg.fusion_pairs:
        raise NotImplementedError(
            "fusion_pairs is not ported yet: ROADMAP.md, still to port, "
            "'Fusion mode'")


@dataclasses.dataclass
class DeviceIndex:
    """Index tables resident on one device, in the slab layout."""

    table: torch.Tensor  # int32[n_buckets, 4*bucket]
    stash: torch.Tensor
    main_slots: int
    stash_slots: int
    bucket: int
    k: int

    @classmethod
    def from_host(cls, index: KMerIndex, device) -> "DeviceIndex":
        def put(t):
            return torch.from_numpy(device_table_layout(t, index.bucket)).to(
                device)

        return cls(table=put(index.table), stash=put(index.stash),
                   main_slots=index.main_slots,
                   stash_slots=index.stash_slots, bucket=index.bucket,
                   k=index.k)


def map_step(di: DeviceIndex, cfg: MapConfig, table: SigTable, codes,
             lengths, weights, codes2=None, lengths2=None, bad=None,
             bad2=None, pad_len: int | None = None,
             audit: bool | None = None) -> SigTable:
    """One mapping step on 2-bit packed reads (``pad_len`` is the unpacked
    padded length). Dense mode packs paired reads' windows side by side into
    one (B, 2P) lookup and takes the union of their EC hits; fast mode
    (``probe_sample`` >= 2) resolves each mate as a segment of its own."""
    check_map_config(cfg)
    if pad_len is None:
        raise ValueError("map_step takes 2-bit packed reads (pad_len set)")
    if audit is None:
        audit = cfg.collision_audit
    if cfg.probe_sample >= 2:
        mates = [(codes, bad, lengths)]
        if codes2 is not None:
            mates.append((codes2, bad2, lengths2))
        sig, mapped = fast_cuda.two_phase_signatures(
            mates, pad_len, di.k, cfg.probe_sample, cfg.max_ecs_per_read,
            di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
        return accumulate_cuda.fold_batch(table, sig, mapped, weights=weights,
                                          sig_probe=cfg.sig_probe,
                                          audit=audit)
    out, P = None, max(pad_len - di.k + 1, 0)
    if codes2 is not None:
        shape = (codes.shape[0], 2 * P)
        out = (torch.empty(shape, dtype=torch.int32, device=codes.device),
               torch.empty(shape, dtype=torch.int32, device=codes.device),
               torch.empty(shape, dtype=torch.bool, device=codes.device))
    hi, lo, valid = pack_cuda.pack_canonical_2bit(codes, bad, lengths,
                                                  pad_len, di.k, out=out)
    if codes2 is not None:
        pack_cuda.pack_canonical_2bit(codes2, bad2, lengths2, pad_len, di.k,
                                      out=out, offset=P)
    ecs = probe_cuda.lookup_ecs(hi, lo, valid, di.table, di.main_slots,
                                di.stash, di.stash_slots, di.bucket)
    sig, mapped = sig_cuda.read_signatures(ecs, valid, cfg.max_ecs_per_read)
    return accumulate_cuda.fold_batch(table, sig, mapped, weights=weights,
                                      sig_probe=cfg.sig_probe, audit=audit)


def merge_sig_rows(sig: np.ndarray, count: np.ndarray, total_reads: int,
                   overflow: int, collisions: int = 0) -> "MapResult":
    """Merge raw signature-table rows into a MapResult: one lexsort over
    the occupied rows plus a reduceat.
    Copied from ``seekmer_tpu.map.driver``, which imports JAX."""
    occ = count > 0
    rows = np.ascontiguousarray(sig[occ])
    cnt = count[occ].astype(np.int64)
    C = sig.shape[1]
    if rows.shape[0] == 0:
        sigs = np.empty((0, C), np.int32)
        counts = np.empty(0, np.int64)
    else:
        order = np.lexsort(rows.T[::-1])
        rs, cs = rows[order], cnt[order]
        new = np.ones(rs.shape[0], bool)
        np.any(rs[1:] != rs[:-1], axis=1, out=new[1:])
        starts = np.flatnonzero(new)
        sigs = rs[starts]
        counts = np.add.reduceat(cs, starts)
    if overflow:
        log.warning("%d mapped reads lost to signature-table overflow; "
                    "increase MapConfig.sig_table_bits", overflow)
    if collisions:
        log.warning(
            "%d reads hit a 64-bit signature-fingerprint collision (their "
            "counts merged into a different signature's row)", collisions)
    return MapResult(sigs=sigs, sig_counts=counts, total_reads=total_reads,
                     mapped=int(counts.sum()), overflow=overflow,
                     collisions=collisions)


@dataclasses.dataclass
class MapResult:
    """Host-side mapping summary: distinct signatures + statistics.
    Copied from ``seekmer_tpu.map.driver``, which imports JAX."""

    sigs: np.ndarray  # int32[U, C] sorted EC ids padded with SIG_PAD
    sig_counts: np.ndarray  # int64[U]
    total_reads: int
    mapped: int
    overflow: int  # mapped reads lost to signature-table overflow
    collisions: int = 0  # reads merged by a 64-bit fingerprint collision

    @property
    def unmapped(self) -> int:
        return self.total_reads - self.mapped - self.overflow


def audit_this_batch(cfg: MapConfig, fed_batches: int) -> bool:
    """Audit batch 0 and every ``collision_audit_every``-th after.
    Copied from ``seekmer_tpu.map.driver``, which imports JAX."""
    if not cfg.collision_audit:
        return False
    return fed_batches % max(cfg.collision_audit_every, 1) == 0


class Mapper:
    """Stateful single-device mapper: feed batches, then finalize."""

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 device="cuda"):
        check_map_config(cfg)
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg
        self.device_index = DeviceIndex.from_host(index, self.device)
        self.table = make_sig_table(cfg.sig_table_bits, cfg.max_ecs_per_read,
                                    num_ecs=index.num_ecs,
                                    device=self.device)
        self.total_reads = 0
        self._fed_batches = 0

    def feed(self, batch: ReadBatch) -> None:
        n_real = batch.n_real
        if batch.pad_len is None:  # unpacked rows: pack on the host first
            batch = pack_batch_2bit(batch)

        def u(x):
            return to_device(x, self.device)
        audit = audit_this_batch(self.cfg, self._fed_batches)
        self.table = map_step(
            self.device_index, self.cfg, self.table, u(batch.codes),
            u(batch.lengths), u(batch.weights), codes2=u(batch.codes2),
            lengths2=u(batch.lengths2), bad=u(batch.bad), bad2=u(batch.bad2),
            pad_len=batch.pad_len, audit=audit)
        self._fed_batches += 1
        self.total_reads += n_real

    def run(self, batches: Iterable[ReadBatch]) -> "MapResult":
        for b in batches:
            self.feed(b)
        return self.finalize()

    def make_fld_estimator(self):
        """Fragment-length estimator sharing this mapper's device table
        (``map/fld.py``), or None when the index lacks the FLD payload."""
        if self.index.fld_tid is None:
            return None
        from .fld import FLDEstimator

        return FLDEstimator(self.index, self.device_index)

    def finalize(self) -> MapResult:
        sigs, counts = table_to_host(self.table)
        return merge_sig_rows(sigs, counts, self.total_reads,
                              int(self.table.overflow),
                              collisions=int(self.table.collisions))


def _group_member_lists(flat: np.ndarray, lens: np.ndarray,
                        counts: np.ndarray):
    """Group ragged sorted member lists (CSR: flat values + group lengths)
    by identical content, summing counts; the 128-bit fingerprint grouping
    of the index builder. Returns (member_lists, counts). Copied from
    ``seekmer_tpu.map.driver``, which imports JAX."""
    from ..index.build import _M1, _M2, _M3, _mix64

    G = lens.size
    offs = np.zeros(G + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    pos = np.arange(flat.size, dtype=np.int64) - offs[:-1].repeat(lens)
    t64 = flat.astype(np.uint64)
    c1 = _mix64(t64 * _M3 + pos.astype(np.uint64))
    c2 = c1 ^ (c1 >> np.uint64(29)) ^ (t64 << np.uint64(31)) ^ _M2
    h1 = np.add.reduceat(c1, offs[:-1]) if G else np.empty(0, np.uint64)
    h2 = np.add.reduceat(c2, offs[:-1]) if G else np.empty(0, np.uint64)
    gl = lens.astype(np.uint64)
    h1 = h1 ^ _mix64(gl * _M1)
    h2 = h2 + _mix64(gl ^ _M2)

    order = np.lexsort((h2, h1))
    a, b = h1[order], h2[order]
    new = np.ones(G, bool)
    new[1:] = (a[1:] != a[:-1]) | (b[1:] != b[:-1])
    firsts = order[np.flatnonzero(new)]
    grp = np.cumsum(new) - 1
    gcounts = np.zeros(firsts.size, np.float64)
    np.add.at(gcounts, grp, counts[order])
    member_lists = [
        flat[offs[i]: offs[i] + lens[i]].astype(np.int32) for i in firsts
    ]
    return member_lists, gcounts


def resolve_signatures(
    result: MapResult, index: KMerIndex
) -> Tuple[List[np.ndarray], np.ndarray, int]:
    """Distinct signatures -> final ECs (distinct transcript intersections).

    Returns (member_lists, counts, dropped); dropped = reads whose EC
    intersection is empty. Single-EC signatures take a vectorized path
    (unique + bincount, one CSR gather); multi-EC ones intersect per
    distinct signature. Copied from ``seekmer_tpu.map.driver``, which
    imports JAX.
    """
    pad = np.int32(SIG_PAD)
    sigs, cnts = result.sigs, result.sig_counts
    if sigs.size == 0:
        return [], np.empty(0, np.float64), 0
    n_ec = (sigs != pad).sum(axis=1)
    single = n_ec == 1
    off = index.ec_offsets.astype(np.int64)
    tr = index.ec_transcripts

    uniq_ec, inv = np.unique(sigs[single, 0], return_inverse=True)
    ec_counts = np.bincount(inv, weights=cnts[single].astype(np.float64),
                            minlength=uniq_ec.size)
    s_start = off[uniq_ec]
    s_len = off[uniq_ec + 1] - s_start
    o = np.zeros(uniq_ec.size + 1, np.int64)
    np.cumsum(s_len, out=o[1:])
    gather = s_start.repeat(s_len) + (
        np.arange(int(o[-1]), dtype=np.int64) - o[:-1].repeat(s_len))
    s_flat = tr[gather].astype(np.int64)

    dropped = 0
    extra_members: List[np.ndarray] = []
    extra_counts: List[float] = []
    for row, n in zip(sigs[~single], cnts[~single]):
        ecs = row[row != pad]
        members = index.ec_members(int(ecs[0]))
        for ec in ecs[1:]:
            members = np.intersect1d(
                members, index.ec_members(int(ec)), assume_unique=True
            )
            if members.size == 0:
                break
        if members.size == 0:
            dropped += int(n)
            continue
        extra_members.append(members.astype(np.int64))
        extra_counts.append(float(n))

    if extra_members:
        flat = np.concatenate([s_flat] + extra_members)
        lens = np.concatenate(
            [s_len, np.fromiter((m.size for m in extra_members), np.int64,
                                len(extra_members))])
        counts = np.concatenate([ec_counts, np.asarray(extra_counts)])
    else:
        flat, lens, counts = s_flat, s_len, ec_counts
    member_lists, gcounts = _group_member_lists(flat, lens, counts)
    return member_lists, gcounts, dropped
