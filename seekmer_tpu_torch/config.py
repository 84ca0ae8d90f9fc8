"""Frozen configuration dataclasses of the pipeline: the port's copy of
``seekmer_tpu/config.py``.

``IndexConfig``, ``MapConfig`` and ``EMConfig`` keep the fields and defaults
of the JAX package, so one configuration means the same run in both
packages (``tests/test_torch_self_contained.py`` checks it). Fields that
pick between XLA and Pallas (``pack_backend``, ``probe_backend``,
``sig_backend``) or bound TPU memory (``probe_chunks``) are kept for that
equality and ignored by the port. ``ShardConfig`` (``PipelineConfig.shard``)
keeps the JAX package's fields: ``data_axis`` is the number of ranks that
map (``parallel/data_parallel.py``), one process a card; with
``index_mode="prefix"`` and ``index_axis`` > 1 the ranks form
``data_axis`` rows of ``index_axis``, each holding one prefix shard of the
index (``parallel/prefix_shard.py``). The axis names name no mesh here (a
rank is a card) and are kept for the equality of the dataclass.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Configuration for k-mer index construction (reference: seekmer index.py)."""

    k: int = 25
    # Target load factor (keys / total slots) of the bucketized main table.
    load_factor: float = 0.5
    # Slots per bucket. One device gather fetches a whole bucket; measured
    # TPU gather cost is per-LANE, not per-byte (one 512B HBM transaction
    # either way), so big buckets are free AND make full buckets —the only
    # reason a lookup ever needs the stash— vanishingly rare
    # (P[Poisson(16) >= 32] ~ 2e-4 at load 0.5).
    bucket_size: int = 32
    # Stash sized at this load; grown 2x until no stash bucket overflows.
    stash_load: float = 0.25
    stash_min_slots: int = 1024
    # Store per-k-mer EC run lengths in the aux column (enables the strided
    # probe mode, MapConfig.probe_stride).
    run_length_aux: bool = True
    # Store per-slot (transcript, position) for globally-unique k-mers —
    # the payload that lets paired-end runs estimate the fragment-length
    # distribution from the data (map/fld.py) instead of requiring the
    # user to guess --fragment-length (reference infer.py's FLD handling
    # is an open parameter, SURVEY.md 3.4).
    fld_positions: bool = True

    def __post_init__(self):
        if not (1 <= self.k <= 29):
            # hi lane packs ceil(k/2) bases (<=30 bits), lo lane the rest.
            raise ValueError(f"k must be in [1, 29], got {self.k}")


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Configuration for pseudoalignment (reference: seekmer mapper.py).

    The reference's Cython inner loop probes k-mers with a skipping heuristic;
    the TPU design probes every valid position in parallel (SURVEY.md 7.4) —
    semantics below define the TPU/oracle-shared behavior.
    """

    # Reads per device batch (per length bucket).
    batch_size: int = 65536
    # Read lengths are bucket-padded to multiples of this to bound recompiles.
    length_bucket: int = 32
    max_read_len: int = 512
    # Cap on distinct index-EC ids contributing to a read's signature; reads
    # exceeding it are treated as unmapped ("complex").
    max_ecs_per_read: int = 16
    # Device-resident signature->count open-addressing table: 2**sig_table_bits
    # slots. Signatures are keyed by a 64-bit fingerprint (collision odds
    # ~U^2/2^64 for U distinct signatures; documented approximation).
    sig_table_bits: int = 20
    # Probe rounds when claiming a signature slot.
    sig_probe: int = 32
    # Audit the fingerprint approximation: every resolved read re-reads its
    # slot's stored signature row and a mismatch (a 64-bit collision merged
    # two distinct signatures) is counted into MapResult.collisions. One
    # extra (B, C)-row gather per audited batch (map/signature.accumulate).
    collision_audit: bool = True
    # Audit every Nth batch (1 = every batch). Auditing costs ~1.5 ms/batch
    # (~5% of the config-1 step, measured 2026-08-21), and a collision
    # persists in the table, so any collider whose signature recurs across
    # batches is still caught by sampling; only colliders appearing
    # EXCLUSIVELY in unaudited batches go unreported (the counter is a
    # diagnostic for an ~U^2/2^64-probability event, not an exact tally).
    collision_audit_every: int = 8
    def __post_init__(self):
        if self.probe_sample >= 2 and self.probe_stride > 1:
            raise ValueError(
                "probe_sample (two-phase fast mode) and probe_stride "
                "(strided-exact mode) are mutually exclusive — pick one")
        if self.probe_sample >= 2 and self.fusion_pairs:
            raise ValueError(
                "probe_sample is not supported in fusion mode (fusion "
                "needs full per-mate signatures; run dense)")
        if not (self.sample_fallback_frac == 0
                or 0 < self.sample_fallback_frac <= 1):
            raise ValueError(
                "sample_fallback_frac must be 0 (auto) or in (0, 1]")

    # Paired-end: a mate with zero k-mer hits contributes nothing (wildcard);
    # both mates empty => unmapped. Matches intersect-mates semantics
    # (reference mapper.py paired-end handling [BASELINE.json:8]).
    paired_end: bool = False
    # Fusion mode (reference seekmer fusion.py, SURVEY.md 2.1 C12): keep
    # each mate's EC signature separately (signature rows widen to
    # 2*max_ecs_per_read) so discordant pairs — mates whose transcript
    # intersections are disjoint — can be resolved into gene-pair fusion
    # candidates (seekmer_tpu/fusion.py). Requires paired_end.
    fusion_pairs: bool = False
    # Probe every stride-th window and fill the gaps via the index's EC
    # run-length guarantees, dense-probing uncovered gaps (ops/probe.py
    # lookup_ecs_strided). 1 = probe every window (bit-exact vs the oracle);
    # >1 differs only when a sequencing-error window collides with an
    # indexed k-mer (~1e-7 per window).
    probe_stride: int = 1
    # Two-phase early-exit probing (ops/probe.two_phase_signatures), the
    # opt-in FAST mode: 0/1 = off (dense, bit-exact vs the oracle);
    # >= 2 = phase 1 probes every Nth window and reads whose sampled hits
    # name ONE distinct EC resolve immediately; a fallback read's
    # ambiguous and zero-hit segments are re-probed densely (its
    # single-EC segments keep their sampled EC). Approximation: a
    # resolved read's signature misses ECs whose runs are shorter than
    # the sample stride and lie strictly between agreeing samples — a
    # SUBSET of its dense signature (which also means a read dense mode
    # would call complex, > max_ecs_per_read distinct, can count as
    # mapped here). Distinct from probe_stride (which is exact via
    # run-length proofs and measured SLOWER than dense).
    probe_sample: int = 0
    # Fast-mode phase-2 cap as a fraction of the batch: each dense
    # fallback round re-probes at most this many reads; residual reads
    # drain through further while_loop rounds (exact coverage — the cap
    # only schedules). The cost landscape is non-monotonic (measured at
    # GENCODE paired, observed fallback 0.315: cap 0.125 -> 73 ms/batch
    # over 3 rounds, 0.25 -> 89, **0.35 -> 56**, 0.5 -> 84): the
    # minimum is the SMALLEST cap that fits the workload's fallback
    # fraction in ONE round — an undersized cap pays extra rounds, an
    # oversized one wastes its filler lanes' gathers.
    # 0 = AUTO (default): the single-chip mapper measures the first fast
    # batch's fallback fraction with a one-off classify-stage program
    # and picks the just-fitting cap from a fixed grid (map/driver.py
    # _pick_fallback_frac; one extra compile + one sync, then steady).
    # Explicit values are respected everywhere; the sharded mappers
    # resolve AUTO to 0.125 (calibration needs a host readback that
    # their shard_map steps do not do).
    sample_fallback_frac: float = 0.0
    # Process the probe's lanes in this many sequential chunks to bound the
    # gathered-bucket-rows transient (4*bucket_size int32 per lane: GBs at
    # GENCODE batch sizes). 0 = auto (chunks sized so the transient stays
    # ~4 GB; 1 chunk for all standard shapes), 1 = force a single pass.
    probe_chunks: int = 0
    # Ship code rows to the device 2-bit packed (0.375 bytes/base: 2-bit
    # codes + invalid bitmask, unpacked exactly on-device) — 2.67x less
    # H2D on the path end-to-end runs bottleneck on
    # (docs/PERFORMANCE.md "End-to-end CLI run"). Single-chip mapper path;
    # the sharded mappers feed unpacked rows.
    h2d_pack_2bit: bool = True
    # Canonical window packing: "xla" (jnp, fused by XLA) or "pallas"
    # (ops/pack_pallas.py kernel).
    pack_backend: str = "xla"
    # Bucket match/select: "xla" (compare fused into the gather by XLA —
    # measured faster, default) or "pallas" (ops/probe_pallas.py explicit
    # fused kernel; requires the gathered rows to round-trip HBM).
    probe_backend: str = "xla"
    # Signature extraction (per-read sorted distinct EC ids — the EC
    # intersection step): "xla" (two jnp row-sorts) or "pallas"
    # (ops/sig_pallas.py fused bitonic kernel).
    sig_backend: str = "xla"
    # Concurrent FASTQ decode threads (the TPU-era analog of the
    # reference's --jobs reader pool, SURVEY.md 2.1 C6): 0 = auto
    # (min(4, n_files); single-end only), 1 = serial deterministic order
    # (required for checkpoint resume; forced automatically when
    # --checkpoint is set), N > 1 = up to N files decoded in parallel.
    # Paired-end parallel decode is OPT-IN (explicit N > 1, never auto):
    # it pairs mate files index-by-index, which rejects layouts where
    # R1/R2 totals match but per-file counts differ — the serial default
    # aligns the concatenated streams and accepts them. gzip inflate is
    # ~0.4M reads/s single-threaded — well below the device map rate.
    io_workers: int = 0


@dataclasses.dataclass(frozen=True)
class EMConfig:
    """Configuration for EM abundance inference (reference: seekmer infer.py)."""

    # Fragment-length model (reference: seekmer infer.py effective-length
    # computation, SURVEY.md section 3.4 — exact upstream formula is an open
    # parameter until the reference mount is readable; both standard forms of
    # the kallisto/salmon class are provided):
    #   sd == 0: eff_len_t = max(len_t - mean_fragment_length + 1, 1)
    #   sd >  0: truncated-normal FLD expectation,
    #            eff_len_t = sum_{f<=len_t} p(f) (len_t - f + 1) / sum p(f)
    #            with p ~ N(mean, sd) on f in [1, mean + 5 sd].
    mean_fragment_length: float = 200.0
    fragment_length_sd: float = 0.0
    # Estimate (mean, sd) from concordantly mapped pairs (map/fld.py) and
    # use them in place of the two values above. Effective only for
    # paired-end runs against an index built with fld_positions; explicit
    # CLI --fragment-length/--fragment-sd flags disable it.
    estimate_fld: bool = True
    # Convergence: stop when max_t |alpha'_t - alpha_t| / (alpha'_t + abs_floor)
    # < rel_tol over transcripts with alpha'_t > count_floor, after min_iters.
    rel_tol: float = 1e-4
    abs_floor: float = 1e-10
    count_floor: float = 1e-8
    min_iters: int = 10
    # A realistic 1M-pair isoform dataset needed ~16k plain-EM iterations
    # (21 s on-device) to reach rel_tol=1e-4 — the previous default cap of
    # 1000 silently truncated EM at ~6% of convergence. The quantifier
    # warns when a run exits at the cap. (The reference's exact cap is an
    # open parameter, SURVEY.md 3.4.)
    max_iters: int = 10000
    # The while_loop's data-dependent condition costs a device<->runtime
    # sync per evaluation; EM steps run in counted inner blocks of this
    # size (a converged flag freezes further updates inside a block, so
    # results and iteration counts are EXACTLY per-iteration semantics).
    check_every: int = 16
    # float64 EM for bit-parity with the oracle (x64 is cheap: EM cost is tiny
    # relative to mapping); float32 available for speed benchmarking.
    use_x64: bool = False
    # Bootstrap replicates (reference infer.py bootstrap loop; config 5 runs
    # 100 [BASELINE.json:11]).
    bootstrap_samples: int = 0
    bootstrap_seed: int = 0
    # Fixed-point acceleration: "none" = plain EM; "squarem" = SQUAREM S3
    # cycles (3 EM steps each: secant extrapolation + stabilizing step) —
    # same fixed points, typically 3-10x fewer EM steps to converge.
    # Applies to the CSR paths — single-run and batched bootstrap (several
    # ranks each run the single-run EM on the merged table). Iteration
    # counts stay in EM-step units.
    # The Pallas dense kernel runs plain EM regardless.
    accel: str = "none"  # "none" | "squarem"
    # EM backend. "auto" = the flat-CSR segment-sum while_loop: with the
    # convergence check hoisted to counted blocks (check_every) it measures
    # ~100x the dense Pallas kernel at every scale, because nnz << E*T
    # (docs/PERFORMANCE.md). "pallas" forces the fused dense fixed-point
    # kernel (ops/em_pallas.py, the explicit-kernel form; VMEM-sized
    # systems only); "csr" forces the sparse path explicitly.
    backend: str = "auto"  # "auto" | "csr" | "pallas"


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Multi-GPU configuration: the JAX package's fields and defaults."""

    # Ranks that map reads (data-parallel, one process a card; 0 or -1:
    # every rank of the process group), and index shards (1: replicated).
    data_axis: int = 1
    index_axis: int = 1
    data_axis_name: str = "reads"
    index_axis_name: str = "index"
    # "replicated" or "prefix" (the prefix-sharded index: index_axis shards)
    index_mode: str = "replicated"


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    index: IndexConfig = IndexConfig()
    map: MapConfig = MapConfig()
    em: EMConfig = EMConfig()
    shard: ShardConfig = ShardConfig()

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)

