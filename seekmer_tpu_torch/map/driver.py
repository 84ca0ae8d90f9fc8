"""Single-device mapping driver: read batches -> map step -> signature
table -> merged signature counts. Counterpart of
``seekmer_tpu/map/driver.py``: dense, fast, strided and fusion mode.

A dense map step is pack (K1) -> lookup with the stash (K2) -> signatures
(K3) -> accumulate (A1), each a kernel on a CUDA device and its plain
PyTorch version on the CPU. A fast one (``MapConfig.probe_sample`` >= 2)
is sample + probe + classify (K5) -> K1, K2 and K3 on the segments that
need a dense re-probe -> merge (K6) -> A1 (``ops/fast_cuda.py``). A
strided one (``MapConfig.probe_stride`` > 1) packs every window as dense
mode does and replaces K2 with K7 (``ops/strided_cuda.py``), each mate of
a pair a segment of its own, so that run-length coverage never crosses
the mate boundary. Fusion mode (``MapConfig.fusion_pairs``, paired reads
only) keeps each mate's signature: K3 writes them side by side at width
2C, mapped is the AND of the mates', and the table has no per-EC vector,
so A1 folds every read through its fingerprint table. Strided and fusion
mode combine. The table stays on the device across batches; the host
only streams, packs and uploads reads, and merges and resolves the
distinct signatures once at the end.

Fast mode has no fallback cap here: every needy segment is re-probed in
one pass, so ``MapConfig.sample_fallback_frac`` is validated by the config
and ignored, and the JAX package's cap calibration
(``_pick_fallback_frac``, ``FALLBACK_FRAC_GRID``,
``Mapper._resolve_fallback_frac``, an extra classify-stage program on the
first batch) and its ``_probe_stage`` bisect hook have no counterpart.
Strided mode has no cap either: K7 looks up every uncovered window in the
same launch.

``MapConfig.pack_backend``, ``probe_backend`` and ``sig_backend`` choose
between XLA and Pallas in the JAX package and are ignored here: which
implementation runs is decided by the device of the tensors alone. The
port always ships reads 2-bit packed, so ``h2d_pack_2bit`` is ignored too.
``_auto_probe_chunks`` and ``probe_chunks`` have no counterpart: the
lookup kernel never materialises the gathered bucket rows they bounded.

``Mapper.run`` checkpoints the table and the stream's resume cursor every
``checkpoint_every`` batches; ranks save together
(``parallel/data_parallel.RankMapper.run``). The table is read
back to the host only when a save is due.

``merge_sig_rows``, ``MapResult``, ``audit_this_batch`` and
``_group_member_lists`` are numpy copies from ``seekmer_tpu/map/driver.py``,
whose module imports JAX at the top; ``MapResult`` also carries the
mapper's EC CSR (``ec_csr``), which every mapper uploads with its index.
``resolve_signatures`` keeps the JAX package's single-EC path and
grouping, and intersects the multi-EC signatures in one call of
``ops/intersect_cuda.intersect`` instead of its Python loop of
``np.intersect1d``: I2 where the result's CSR is on a card, the plain
version where it is on the CPU or absent.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..config import MapConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch, pack_batch_2bit
from ..ops import (accumulate_cuda, fast_cuda, intersect_cuda, layout_cuda,
                   pack_cuda, probe_cuda, sig_cuda, strided_cuda)
from ..ops.probe import device_table_layout
from ..utils.checkpoint import (adapt_ec_count, load_map_checkpoint,
                                save_map_checkpoint)
from ..utils.metrics import Metrics
from .fld import SAMPLE_BATCHES, FLDEstimator
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
    """A batch array as a tensor on ``device``: numpy arrays are uploaded
    (a read-only one, a pack cache's memmap slice, is copied first, never
    wrapped), tensors must already be there; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"batch tensor on {x.device}, expected "
                             f"{device}")
        return x
    if not x.flags.writeable:
        x = np.array(x)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _upload_raw(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host index table copied to ``device`` as it is: int32, contiguous,
    with no host copy of a read-only array (the copy only reads it)."""
    host = np.ascontiguousarray(table, dtype=np.int32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is "
                                "not writable")
        return torch.from_numpy(host).to(device)


def upload_ec_csr(index: KMerIndex, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """The index's EC CSR (``ec_offsets``, ``ec_transcripts``) as int32
    tensors on ``device``, for ``resolve_signatures``' intersections."""
    dev = torch.device(device)
    return (_upload_raw(index.ec_offsets, dev),
            _upload_raw(index.ec_transcripts, dev))


@dataclasses.dataclass
class DeviceIndex:
    """Index tables resident on one device, in the slab layout, and the EC
    CSR."""

    table: torch.Tensor  # int32[n_buckets, 4*bucket]
    stash: torch.Tensor
    main_slots: int
    stash_slots: int
    bucket: int
    k: int
    ec_csr: Tuple[torch.Tensor, torch.Tensor]  # int32 offsets, transcripts

    @classmethod
    def from_host(cls, index: KMerIndex, device,
                  metrics: Optional[Metrics] = None) -> "DeviceIndex":
        """The table and the stash in the slab layout on ``device``, and
        the EC CSR (spans ``index_upload`` and ``index_layout`` of
        ``metrics``; counter ``index_upload_bytes``, the CSR's bytes
        included). On a CUDA device the raw (S, 4) tables are copied as
        they are, then laid out in place by I1 (``ops/layout_cuda.py``;
        counter ``index_layout_on_device``); on the CPU
        ``device_table_layout`` lays them out on the host first."""
        metrics = metrics if metrics is not None else Metrics()
        dev = torch.device(device)
        raw = (index.table, index.stash)
        metrics.count("index_upload_bytes", sum(
            t.nbytes for t in (*raw, index.ec_offsets, index.ec_transcripts)))
        if dev.type == "cpu":
            with metrics.span("index_layout"):
                host = [device_table_layout(t, index.bucket) for t in raw]
            with metrics.span("index_upload"):
                table, stash = (torch.from_numpy(t) for t in host)
                ec_csr = upload_ec_csr(index, dev)
        else:
            with metrics.span("index_upload"):
                table, stash = (_upload_raw(t, dev) for t in raw)
                ec_csr = upload_ec_csr(index, dev)
            with metrics.span("index_layout"):
                table, stash = layout_cuda.layout_table(table, stash,
                                                        bucket=index.bucket)
            metrics.count("index_layout_on_device")
        return cls(table=table, stash=stash,
                   main_slots=index.main_slots,
                   stash_slots=index.stash_slots, bucket=index.bucket,
                   k=index.k, ec_csr=ec_csr)


def map_step(di: DeviceIndex, cfg: MapConfig, table: SigTable, codes,
             lengths, weights, codes2=None, lengths2=None, bad=None,
             bad2=None, pad_len: int | None = None,
             audit: bool | None = None) -> SigTable:
    """One mapping step on 2-bit packed reads (``pad_len`` is the unpacked
    padded length). Dense and strided mode pack paired reads' windows side
    by side into one (B, 2P) lookup; dense mode takes the union of their EC
    hits in one signature, fusion mode one signature a mate. Fast mode
    (``probe_sample`` >= 2) resolves each mate as a segment of its own.
    Every mode but fast mode counts its complex reads into
    ``table.complex`` (``Mapper.counts_complex``)."""
    if pad_len is None:
        raise ValueError("map_step takes 2-bit packed reads (pad_len set)")
    if audit is None:
        audit = cfg.collision_audit
    mates = [(codes, bad, lengths)]
    if codes2 is not None:
        mates.append((codes2, bad2, lengths2))
    if cfg.probe_sample >= 2:  # MapConfig rules out stride and fusion here
        sig, mapped = fast_cuda.two_phase_signatures(
            mates, pad_len, di.k, cfg.probe_sample, cfg.max_ecs_per_read,
            di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
        return accumulate_cuda.fold_batch(table, sig, mapped, weights=weights,
                                          sig_probe=cfg.sig_probe,
                                          audit=audit)
    if cfg.fusion_pairs and codes2 is None:
        raise ValueError("fusion_pairs needs paired-end reads: a fusion "
                         "signature is one per mate (MapConfig.fusion_pairs)")
    hi, lo, valid = pack_cuda.pack_mates(mates, pad_len, di.k)
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    if cfg.probe_stride > 1:
        ecs = strided_cuda.lookup_ecs_strided(
            hi, lo, valid, *geo, cfg.probe_stride,
            segments=1 if codes2 is None else 2)
    else:
        ecs = probe_cuda.lookup_ecs(hi, lo, valid, *geo)
    sig, mapped = sig_cuda.read_signatures(
        ecs, valid, cfg.max_ecs_per_read,
        segments=2 if cfg.fusion_pairs else 1, n_complex=table.complex)
    return accumulate_cuda.fold_batch(table, sig, mapped, weights=weights,
                                      sig_probe=cfg.sig_probe, audit=audit)


def merge_sig_rows(sig: np.ndarray, count: np.ndarray, total_reads: int,
                   overflow: int, collisions: int = 0,
                   complex_reads: Optional[int] = None,
                   ec_csr=None) -> "MapResult":
    """Merge raw signature-table rows into a MapResult: one lexsort over
    the occupied rows plus a reduceat; ``ec_csr`` is handed on.
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
                     collisions=collisions, complex_reads=complex_reads,
                     ec_csr=ec_csr)


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
    # unmapped reads past the class cap; None where not counted (fast mode,
    # the prefix-sharded mapper)
    complex_reads: Optional[int] = None
    # the mapper's EC CSR (int32 offsets, transcripts) on its device, where
    # resolve_signatures intersects; None for a result built on the host
    ec_csr: Optional[Tuple[torch.Tensor, torch.Tensor]] = dataclasses.field(
        default=None, repr=False, compare=False)

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
    """Stateful single-device mapper: feed batches, then finalize. Its
    spans and counters (the index's build, ``fld``, ``batches``,
    ``finalize``) go into ``metrics``, the caller's run's when given.

    The Quantifier's one interface, the same on several ranks
    (``parallel/data_parallel.RankMapper``): ``select``, ``run``,
    ``restore``, ``fld_estimate`` and ``finalize``, and for the stage
    snapshots and the bootstrap ``rank``, ``n_ranks`` and ``from_rank0``.
    A mapper that holds its index otherwise overrides ``_upload_index``
    (returning the EC CSR), ``_new_table`` and ``_fold``."""

    rank, n_ranks = 0, 1
    fld_batches = SAMPLE_BATCHES  # the paired batches the FLD samples

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 device="cuda", metrics: Optional[Metrics] = None,
                 estimate_fld: bool = False):
        """``estimate_fld`` (``EMConfig.estimate_fld``): ``feed`` samples
        the first paired batches' fragment lengths, where the index
        carries the FLD payload."""
        self.device = check_device(device)
        self.index = index
        self.cfg = cfg
        self.metrics = metrics if metrics is not None else Metrics()
        self.estimate_fld = estimate_fld and index.fld_tid is not None
        self.ec_csr = self._upload_index()
        self._reset()

    @property
    def counts_complex(self) -> bool:
        # K3 counts complex reads in every mode but fast mode, where K5
        # resolves most reads without K3
        return self.cfg.probe_sample < 2

    def _upload_index(self) -> Tuple[torch.Tensor, torch.Tensor]:
        self.device_index = DeviceIndex.from_host(self.index, self.device,
                                                  self.metrics)
        return self.device_index.ec_csr

    def _new_table(self) -> SigTable:
        # fusion rows hold a signature a mate side by side, which the
        # per-EC direct vector cannot count: the placeholder vector sends
        # every read through the fingerprint table, as in the JAX package
        cfg = self.cfg
        return make_sig_table(
            cfg.sig_table_bits,
            cfg.max_ecs_per_read * (2 if cfg.fusion_pairs else 1),
            num_ecs=0 if cfg.fusion_pairs else self.index.num_ecs,
            device=self.device)

    def _reset(self) -> None:
        """A fresh run: an empty table, nothing fed, no FLD estimator
        (made in ``feed``, or restored with a checkpoint's state)."""
        self.table = self._new_table()
        self.total_reads = 0
        self._fed_batches = 0
        self.fld = None

    def select(self, batches: Iterable[ReadBatch]) -> Iterable[ReadBatch]:
        """The batches this mapper maps: on one card, all of them."""
        return batches

    @staticmethod
    def from_rank0(x: np.ndarray) -> np.ndarray:
        """Rank 0's ``x`` on every rank: on one card, ``x``."""
        return x

    def feed(self, batch: ReadBatch) -> None:
        """Sample the batch's fragment lengths (span ``fld``) while the
        estimator is active, then map it."""
        if self.estimate_fld:
            if self.fld is None and batch.codes2 is not None:
                self.make_fld_estimator()
            if self.fld is not None and self.fld.active:
                with self.metrics.span("fld"):
                    self.fld.feed(batch)
        n_real = batch.n_real
        if batch.pad_len is None:  # unpacked rows: pack on the host first
            batch = pack_batch_2bit(batch)
        self._fold(batch)
        self._fed_batches += 1
        self.total_reads += n_real
        self.metrics.count("batches")

    def _fold(self, batch: ReadBatch) -> None:
        """Map a 2-bit packed batch into the table."""
        def u(x):
            return to_device(x, self.device)
        audit = audit_this_batch(self.cfg, self._fed_batches)
        self.table = map_step(
            self.device_index, self.cfg, self.table, u(batch.codes),
            u(batch.lengths), u(batch.weights), codes2=u(batch.codes2),
            lengths2=u(batch.lengths2), bad=u(batch.bad), bad2=u(batch.bad2),
            pad_len=batch.pad_len, audit=audit)

    def run(self, batches: Iterable[ReadBatch],
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50) -> "MapResult":
        """Feed every batch, then finalize. With ``checkpoint_path``, save
        the table and the resume cursor every ``checkpoint_every`` batches,
        at the next batch that carries a cursor, and once at the end; the
        cursor saved is that of the batch just fed, not the reader's
        position (a prefetch thread may be batches ahead)."""
        n = 0
        due = warned = False
        last_cursor = None
        for batch in batches:
            self.feed(batch)
            n += 1
            cur = batch.cursor
            if cur is not None:
                last_cursor = cur
            if checkpoint_path:
                due = due or (n % checkpoint_every == 0)
                if due and cur is not None:
                    self.save_checkpoint(checkpoint_path, stream_state=cur)
                    due = False
                elif due and last_cursor is None and not warned:
                    log.warning(
                        "checkpointing requested but these batches carry no "
                        "resume cursors (not from CheckpointableBatchSource); "
                        "periodic checkpoints are disabled, and a final "
                        "table snapshot that cannot resume is written")
                    warned = True
        if checkpoint_path:
            self.save_checkpoint(checkpoint_path, stream_state=last_cursor)
        return self.finalize()

    def save_checkpoint(self, path: str,
                        stream_state: Optional[dict] = None) -> None:
        save_map_checkpoint(path, self.table, self.total_reads,
                            stream_state, fld=None if self.fld is None
                            else self.fld.state())

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        """Restore the table, the read count and the FLD estimator's state
        where the file has one (``self.fld``); returns the stream's resume
        cursor (``CheckpointableBatchSource.restore``'s input), {} when the
        file carries no cursor (the table is restored but the stream
        position is unknown: not safely resumable), or None when there is
        no file."""
        loaded = load_map_checkpoint(path, self.device)
        if loaded is None:
            return None
        table, self.total_reads, stream_state, fld = loaded
        self.table = adapt_ec_count(table, self.table.ec_count.shape)
        if fld is not None:
            self.make_fld_estimator(fld)
        return stream_state if stream_state is not None else {}

    def restore(self, checkpoint_path: str, source) -> None:
        """Restore the map checkpoint, if any, into this mapper and
        ``source``. A file without a cursor cannot resume: the table is
        dropped and the run starts fresh. Restore errors raise; on several
        ranks only once every rank has tried (``restore_checkpoint``)."""
        state = self.restore_checkpoint(checkpoint_path)
        if state:
            source.restore(state)
            log.info("resuming from checkpoint: %d reads already mapped",
                     self.total_reads)
        elif state is not None:
            log.warning("checkpoint %s has no stream cursor; starting fresh",
                        checkpoint_path)
            self._reset()

    def make_fld_estimator(self, state=None):
        """Fragment-length estimator sharing this mapper's device table
        (``map/fld.py``), from a checkpoint's ``state`` or afresh, or None
        when the index lacks the FLD payload."""
        if self.index.fld_tid is None:
            return None
        self.fld = FLDEstimator(self.index, self.device_index, state,
                                sample_batches=self.fld_batches)
        return self.fld

    def fld_estimate(self) -> Optional[Tuple[float, float, int]]:
        """(mean, sd, n) of the sampled fragment lengths, or None when
        they are not estimated or too few pairs were sampled."""
        if not self.estimate_fld or self.fld is None:
            return None
        return self.fld.estimate()

    def _gather(self, sigs: np.ndarray, counts: np.ndarray,
                counters: List[int]):
        """Every rank's rows, the counters summed: on one card, its own."""
        return sigs, counts, counters

    def finalize(self) -> MapResult:
        """The table read back (span ``readback``; its three counters in
        one copy), gathered over the ranks (``_gather``) and merged
        (``merge``), inside the span ``finalize``."""
        m = self.metrics
        t = self.table
        with m.span("finalize"):
            with m.span("readback"):
                sigs, counts = table_to_host(t, m)
                counters = [self.total_reads] + torch.stack(
                    [t.overflow, t.collisions, t.complex]).tolist()
            sigs, counts, counters = self._gather(sigs, counts, counters)
            total, overflow, collisions, complex_reads = counters
            with m.span("merge"):
                return merge_sig_rows(
                    sigs, counts, total, overflow, collisions=collisions,
                    complex_reads=(complex_reads if self.counts_complex
                                   else None),
                    ec_csr=self.ec_csr)


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
    (unique + bincount, one CSR gather). The multi-EC ones are intersected
    in one ``intersect_cuda.intersect`` call on the device of
    ``result.ec_csr`` (I2 on a card; the plain version on the CPU, with
    the index's CSR where the result carries none), in the span
    ``intersect`` of the current metrics (``Metrics.active``): their rows'
    upload, the call and one read-back of its results, the span's last
    sync. Counters: ``intersect_members`` (the summed sizes of every EC
    list of every multi-EC signature) and ``intersect_on_device`` (1 where
    I2 ran). The flat lists, lengths and counts grouped into classes are
    those of the JAX package's loop (``seekmer_tpu.map.driver``), in its
    order.
    """
    metrics = Metrics.current() or Metrics()
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

    multi, m_cnts = sigs[~single], cnts[~single]
    M = multi.shape[0]
    csr = result.ec_csr
    if csr is None:
        csr = upload_ec_csr(index, "cpu")
    with metrics.span("intersect"):
        got = intersect_cuda.intersect(
            torch.from_numpy(np.ascontiguousarray(multi, np.int32)).to(
                csr[0].device),
            *csr)
        host = torch.cat([got.lens.to(torch.int64), got.starts,
                          got.values.to(torch.int64)]).cpu().numpy()
    metrics.count("intersect_members", got.members)
    metrics.count("intersect_on_device", int(got.on_device))
    lens, starts, values = host[:M], host[M:2 * M], host[2 * M:]
    # each slot's survivors are its first lens entries
    slot = np.diff(starts, append=values.size)
    m_flat = values[np.arange(values.size)
                    < np.repeat(starts + lens, slot)]
    kept = lens > 0
    dropped = int(m_cnts[~kept].sum())

    flat = np.concatenate([s_flat, m_flat])
    lens = np.concatenate([s_len, lens[kept]])
    counts = np.concatenate([ec_counts, m_cnts[kept].astype(np.float64)])
    member_lists, gcounts = _group_member_lists(flat, lens, counts)
    return member_lists, gcounts, dropped
