#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seekmer_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--keep-inputs PATH] [--dp-cards N[,N...]]

(``--keep-inputs`` also writes K3's, fast mode's and R1's inputs of the
config-2 batch to PATH and A4's to PATH.a4.pt, for ``python -m
seekmer_tpu_torch.utils.kernel_ab``, and config 2's EC table to
PATH.c2_ec.npz, for ``python -m tests.test_torch_bootstrap``.
``--dp-cards 2,4`` runs only phase 7's ``[dp ...]`` and phase 8's
``[ps ...]`` checks, over NCCL with a rank on
each of 2, then 4 cards, after the one-rank runs they are held to; it
holds no kernel against its plain version, so its last line is
``{"dp_cards_ok": true, ...}``, never the full run's ``{"ok": true,
...}``.)

Phases; any failure exits non-zero:

1. print the card's name and power limit, build the kernels from
   ``seekmer_tpu_torch/csrc`` with nvcc (sm_90a, one nvcc per source);
2. make two worlds from a seed and index them through the port's CLI: the
   config-1 world (1000 random transcripts, 4 x 65,536 single-end 100 bp
   reads) and the config-2 GENCODE-scale isoform world (20,000 genes,
   4 x 65,536 read pairs of 100 bp, fragments 200 +- 20,
   sig_table_bits=22, indexed with a GTF of its genes), and fuse's input:
   10 gene pairs x 100 error-free chimeric read pairs, then the first
   config-2 batch;
3. hold each kernel against its plain PyTorch version on the card and time
   both with CUDA events, beside the least time the card could take for
   the same work (bytes over 3.35 TB/s, or FP32 operations over 67
   TFLOP/s; for K4 the operations on M's nonzeros): K1 pack (one mate,
   and both mates into one output), K2 lookup, K3 signature and A1
   accumulate at the shapes of one paired config-2 batch, K2 also on one
   config-1 batch (a table that mostly sits in L2); R1 (route: owner,
   rank within the owner, round 0's send slab and the spill list in one
   pass; a later round's slab from the spill list) and R2 (unroute) on
   the first half of the config-2 batch, a rank's rows at 2 ranks, in
   one round and in three (``[R1 route config 2]``, ``[R2 unroute config
   2]``, R2 beside ``index_put_``); K3 also on the rows of
   ``tests/synthetic_signatures.py`` (both of its paths), with the
   run-head histogram of both batches; A1 also on a table pre-seeded with
   a colliding key, timed as claim alone and claim plus audit, empty
   table and steady state, beside an empty launch of its grid and its
   host enqueue (K3's and A1's device times with the card kept busy while
   the host enqueues, ``utils/kernel_ab.py``); K4 dense EM at the
   config-1 bootstrap shapes (the world's ECs, 100 resampled replicates)
   and at R = 1, to convergence and for the same
   fixed iteration count (with a TF32 control of the plain version that
   must miss the bound, and a rerun that must give the same bits), with
   A3 (the CSR EM fixed point) timed beside it on the same systems, then
   on two systems at the dense gate's edge, E-deep and T-deep, that walk
   their depth in chunks; fast mode's K5 (sample + probe + classify) and
   K6 (merge) on the config-2 batch at strides 16, 8 and 2 and on the
   single-end config-1 batch at 16 and 2, with the resolved-read and
   fallback-unit fractions and every fast signature checked to equal, or
   be a non-empty subset of, the dense one, K5 timed beside K2 on exactly
   its valid sampled keys and K6 beside an empty launch of its grid; the
   device map step on the pre-uploaded config-2 batch dense and fast
   (``[map step]``, ``[map step fast s=16]``, ``[map step fast s=8]``) and
   on the config-1 batch (``[map step config 1]``, ``[map step config 1
   fast s=16]``),
   the card's idle time at the fast step's unit-count readback from a
   ``torch.profiler`` trace (``[map step fast s=16 readback]``), and the
   fast step's table held against the plain route's on the same card
   tensors; strided mode's K7 bit for bit against its plain version and
   against K2's result on the same windows (every dense hit equal, every
   difference a fill over a dense miss) on the config-2 batch (each mate a
   segment) at strides 2, 4, 8 and 16 and the config-1 batch at 4, timed
   beside K2 on the whole batch and on exactly the keys K7 looks up
   (``[K7 strided ...]``), with its plan (segments a tile, tiles, resident
   warps, staging bytes a warp) and the build's registers and spill
   bytes for the form it ran (``[K7 strided ... tiles]``); K3 with ``segments=2`` (fusion mode's per-mate
   signatures) against its plain version (``[K3 segments=2 config 2]``),
   and those signatures folded by A1 into a 2C-wide table with no per-EC
   vector, every read through the CAS as in ``fuse``, against its plain
   version, with the table's fill and overflow
   (``[A1 accumulate fusion width]``);
4. run ``infer --device cuda`` of the port's CLI on both worlds with every
   kernel's launch count set to 0 just before and read just after:
   config 1 with ``--bootstrap 100`` (the dense route, through K4; the
   mapped count and the point estimate checked against the port's plain
   path on the CPU with float64 EM, which the CPU tests hold against the
   JAX package and its float64 oracle),
   config 2 paired with no fragment flags (the fragment-length estimate
   checked against the simulated one) and ``--bootstrap 100`` (the
   batched CSR route, through A3; single-run EM takes A3 in every run);
   then ``infer --probe-sample 16`` on both (fast
   mode: config 1's mapped and unmapped counts checked against the port's
   plain fast path on the CPU; config 2 paired with the FLD estimated and
   its mapped count beside the dense run's), then ``infer --probe-stride
   4`` on both (strided mode: K7 launched and no standalone K2; config
   1's MapResult on the card equal to the plain strided path on the CPU;
   mapped counts beside the dense runs'); check the outputs and print the
   stage rates; then ``fuse`` at config 2 (every injected gene pair called
   with its support; ``fusion.detect_fusions_files`` with
   ``MapConfig(probe_stride=4)`` giving the same table);
5. trace the map stage (``Mapper.run`` fed as ``infer`` feeds it, dense,
   then fast at s = 16, then strided at s = 4), a fixed 480-iteration EM and a fixed
   480-iteration 100-replicate bootstrap on both worlds with
   ``torch.profiler``; print each stage's wall time untraced and traced,
   its device busy time, and the device time per kernel or copy. On
   config 2, before its EM is traced, A3 is held against its plain
   version at the EC table's shapes (``[A3 ...]``): the tiling (components,
   tiles, slices, resident or streamed, shared memory); the whole fixed
   point in one launch against the plain blocked loop on the CPU at 100
   replicates and at 1, float32 and float64, at a rel_tol at which the
   test stops it before max_iters (equal iteration count, flag and bits); one 16-step launch at
   100 replicates bit for bit against the CPU and a rerun; 480 iterations
   within the group-mass bound of the plain version on the card;
   ``batched_em`` (4 replicates) and ``run_em`` (float32, float64) on the
   card bit for bit against the same calls on the CPU over 480 iterations,
   one launch each; then the fixed point timed over 480 iterations at 100
   replicates and at 1, float32 and float64, beside its bound (inputs and outputs once a
   launch, the iterations' operations), its plain blocked loop and two
   cuSPARSE products an iteration. ``infer`` must launch A3 once a fixed
   point. Then A4, ``log_likelihood``'s per-EC sums in nnz order
   (``[A4 ec_sum config 2]``), one launch a call, bit for bit against its
   plain version on the card and the CPU, timed beside it,
   ``index_add_``, ``segment_reduce`` (its bits compared with A4's) and
   an empty launch of its grid; ``infer`` launches it once a run.
6. checkpoints, the pack cache, traces and reads in memory, each run
   with the launch counts set to 0 just before and read just after (K1,
   K2, K3 and A1 must launch, and A3 where EM runs):
   ``[checkpoint c2 map]``: ``Quantifier.quantify_files`` on config 2
   (FLD estimated) with a checkpoint every batch, stopped after batch 2's
   save and resumed in a fresh Quantifier: the run without a checkpoint's
   signature counts, FLD estimate and est_counts bits; seconds a save,
   bytes a checkpoint, restore seconds. ``[checkpoint c2 em]``: on config
   2's EC table ``run_em`` (float32, float64) and the B 100 bootstrap
   (``run_bootstrap`` float32, ``batched_em`` float64), each stopped at
   its first snapshot and resumed: one A3 launch's bits and iteration
   count; the fixed point's pieces and ms beside one launch. ``[pack
   cache c2]``: ``infer --pack-cache DIR`` twice (build, hit) against the
   FASTQ run's abundance.tsv, their map stages; a checkpointed run on the
   cached batches stopped and resumed (exact); the cache rebuilt and that
   checkpoint refused (fault 2). ``[trace c1]``, ``[trace c2]``: ``infer
   --trace-dir``, the trace's kernels and stage ranges beside
   run_info.json's timings and the map stage's split (ingest, upload,
   device busy). ``[c1 reads in memory]``: ``Quantifier.quantify_reads``
   against ``quantify_files``: mapped and est_counts bits.
7. several ranks (run right after ``[checkpoint c2 map]``): 2 ranks on
   the one card over gloo (NCCL refuses two ranks on one GPU), spawned by
   ``parallel.comm.launch`` with ``devices=["cuda:0"] * 2`` under a
   deadline, each rank's kernels on the card. ``[dp c2 map]``: the main
   path, ``Quantifier`` with ``ShardConfig(data_axis=2)`` on config 2
   (FLD estimated, ``--bootstrap 100``), launch counts from 0 in each
   rank and summed: the merged MapResult, the FLD histogram summed over
   the ranks and est_counts equal to the one-rank run's; the ranks' walls
   beside one card's end to end. ``[dp c2 em]``: the quantifier's EM on
   several ranks, ``run_em`` on every rank's merged table (float32,
   float64), bit-equal on every rank to one card's run alone with the
   same iteration count; walls. ``[dp c2 bootstrap]``: the B 100 sharded
   bootstrap bit-equal to one card's ``batched_em`` on the gathered count
   matrix, the row masses, walls, a block's exchange alone. ``[dp c2
   resume]``: a checkpointed 2-rank run stopped after its first save and
   resumed to one rank's est_counts bits; a sidecar a step ahead refused
   on both ranks. ``[dp c1 fast]``, ``[dp c1 strided]``:
   ``probe_sample`` 16 and ``probe_stride`` 4 at 2 ranks, mapped equal to
   one rank's ``infer``.
8. the prefix-sharded index (run last, after phase 9): 2
   ranks on the one card over gloo, index layout (1, 2), a prefix shard
   of the index a rank, lookups routed by ``all_to_all`` (R1, K2 on the
   shard, R2), launch counts from 0 in each rank. ``[ps c2 map]``: the
   main path, ``Quantifier`` with ``ShardConfig(index_axis=2,
   index_mode="prefix")`` on config 2 (FLD estimated against shard 0,
   ``--bootstrap 100``): the merged MapResult equal to one card's; the
   shard-0 FLD histogram summed over the ranks equal to one card's
   shard-0 estimator fed the global batches whole; est_counts bit-equal
   to one card's quantifier given that fragment length; R1, R2, K1-K3
   and A1 launched on each rank; walls, the shards' build apart, the
   bytes an ``all_to_all`` moves, and one ``all_to_all`` of a round's
   slab hi timed. ``[ps c2 fast s=16]``: sampled
   routing, the MapResult equal to one card's fast mode (no K5).
   ``[ps c1 low-capacity]``: config 1 at capacity factor 0.3, extra
   routing rounds > 0 and the MapResult equal to one card's.
9. the compiled single-core CPU baseline (``native/cpu_baseline``, run
   after phase 5's traces) on the card's host, with the host CPU's model
   and usable cores and the card's name and power limit on every line:
   ``[baseline c1]`` maps every read of c1.fq once (mapped and distinct
   signatures equal to the plain path's raw MapResult on the CPU, before
   the resolve drops), then times the dense and the skip arm on the first
   batch (a warm-up of 256 rows, the best of 5 passes, every pass shown);
   ``[baseline c2]`` maps the first pair batch's 131,072 mate rows, each
   a single-end read, with the port's dense ``Mapper`` on the card (K1-K3
   and A1, launch counts from 0) and times both arms on them (the dense
   arm's mapped and distinct signatures equal to the port's). The skip
   arm's mapped may differ from the dense arm's by at most 0.1% of the
   rows. Each prints the port's reads/s over 10x the baseline's: the
   device map step and the map stage as ``infer`` ran it (phase 4's
   ``timings.map_s``) against the dense arm, both at fast s = 16 against
   the skip arm.

The last three lines are the card's name and power limit, the JSON line of
kernel results, and ``{"ok": true, "device": {...}}``. JAX and the JAX
package ``seekmer_tpu`` are blocked for the whole run: the port must not
need them. Float32 products run in full FP32 (TF32 off) for the plain
versions.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.modules["jax"] = None  # any import of JAX now fails
sys.modules["seekmer_tpu"] = None  # and of the JAX package

REPO = Path(__file__).resolve().parent
B = 65536  # reads (pairs) per batch, the CLI default
BATCHES = 4
READ_LEN = 100
SEED = 0
C1_TRANSCRIPTS = 1000
C2_GENES = 20000
FUSION_GENES = 10  # gene pairs injected into fuse's input at config 2
FUSION_PAIRS = 100  # chimeric read pairs each
STRIDES = (2, 4, 8, 16)  # K7 at config 2; infer and fuse run at s = 4
DEVICE = "cuda"
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
FP64_FLOPS = 34e12  # outside the tensor cores (the same data sheet)
TF32_FLOPS = 495e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def load_index(work: Path, tag: str):
    """World ``tag``'s index, loaded once for the whole run (config 2's
    compressed file takes seconds to load) and shared by the phases of this
    process; its arrays are made read-only, so a phase cannot change what
    a later one reads."""
    from seekmer_tpu_torch.index.store import KMerIndex

    index = KMerIndex.load(str(work / f"{tag}.npz"))
    for value in vars(index).values():
        if hasattr(value, "flags"):
            value.flags.writeable = False
    return index


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def reads_from_codes(codes):
    import numpy as np

    ascii_ = np.frombuffer(b"ACGTN", np.uint8)[np.minimum(codes, 4)]
    return [row.tobytes().decode() for row in ascii_]


def make_worlds(work: Path):
    """Write both worlds' FASTA and FASTQ files and index them with the
    port's CLI. Returns the first config-1 batch and the first paired
    config-2 batch (both mates' codes)."""
    import numpy as np

    from seekmer_tpu_torch import cli
    from seekmer_tpu_torch.utils.simulate import (
        isoform_transcriptome, random_transcriptome, simulate_packed_batches,
        simulate_packed_pairs, write_fasta, write_fastq)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    names, seqs = random_transcriptome(rng, num_transcripts=C1_TRANSCRIPTS,
                                       min_len=300, max_len=3000,
                                       shared_prefix_frac=0.5)
    write_fasta(str(work / "c1.fa"), names, seqs)
    codes, _ = simulate_packed_batches(rng, seqs, BATCHES, B, READ_LEN)
    write_fastq(str(work / "c1.fq"),
                reads_from_codes(codes.reshape(-1, READ_LEN)))
    batch1 = codes[0]
    check(cli.main(["index", str(work / "c1.fa"), str(work / "c1.npz")]) == 0,
          "config-1 index build")
    log(f"[setup] config-1 world: {C1_TRANSCRIPTS} transcripts, "
        f"{BATCHES * B} reads, "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    names, seqs, genes = isoform_transcriptome(rng, num_genes=C2_GENES)
    write_fasta(str(work / "c2.fa"), names, seqs)
    with open(work / "c2.gtf", "w") as fh:
        for n, g in zip(names, genes):
            fh.write(f"chr1\tsim\ttranscript\t1\t2\t.\t+\t.\t"
                     f'gene_id "{g}"; transcript_id "{n}";\n')
    c1, c2, _ = simulate_packed_pairs(rng, seqs, BATCHES, B, READ_LEN,
                                      mean_frag=200.0, sd_frag=20.0)
    for name, codes in (("c2_1.fq", c1), ("c2_2.fq", c2)):
        write_fastq(str(work / name),
                    reads_from_codes(codes.reshape(-1, READ_LEN)))
    batch2 = (c1[0], c2[0])
    injected = write_fusion_pairs(work, names, seqs, genes, batch2)
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(cli.main(["index", str(work / "c2.fa"), str(work / "c2.npz"),
                    "--gtf", str(work / "c2.gtf")]) == 0,
          "config-2 index build")
    log(f"[setup] config-2 world: {len(seqs)} transcripts from {C2_GENES} "
        f"genes, "
        f"{BATCHES * B} pairs; simulate {t_sim:.1f} s, index build + save "
        f"{time.perf_counter() - t0:.1f} s")
    return batch1, batch2, injected


def write_fusion_pairs(work: Path, names, seqs, genes, batch2):
    """``fuse``'s input at config 2: FUSION_PAIRS chimeric read pairs (mate
    1 from a transcript of gene A, mate 2 the reverse complement of the
    same span of a transcript of gene B, error-free) for each of
    FUSION_GENES gene pairs drawn from a seed, then the first config-2
    batch. Returns the injected gene pairs."""
    import numpy as np

    from seekmer_tpu_torch.utils.simulate import write_fastq

    first = {}
    for s, g in zip(seqs, genes):
        if len(s) >= 2 * READ_LEN + FUSION_PAIRS and g not in first:
            first[g] = s
    picked = np.random.default_rng(SEED + 1).choice(
        sorted(first), size=2 * FUSION_GENES, replace=False)
    injected = [(str(picked[2 * i]), str(picked[2 * i + 1]))
                for i in range(FUSION_GENES)]
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = [], []
    for ga, gb in injected:
        for i in range(FUSION_PAIRS):
            r1.append(first[ga][i:i + READ_LEN])
            r2.append(first[gb][i:i + READ_LEN][::-1].translate(comp))
    for name, reads, codes in (("fuse_1.fq", r1, batch2[0]),
                               ("fuse_2.fq", r2, batch2[1])):
        write_fastq(str(work / name), reads + reads_from_codes(codes))
    return injected


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_each(setup, fn, reps: int) -> float:
    """Mean ms of ``fn(setup())`` over ``reps``, timing ``fn`` alone."""
    import torch

    fn(setup())
    spans = []
    for _ in range(reps):
        arg = setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / reps


def max_abs_diff(a, b) -> int:
    import torch

    check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def record(err, ms, plain_ms, bound_s, bound_by, library_ms=None) -> dict:
    """One kernel's line in the kernels JSON; ``bound_s`` is the least time
    the card could take for the same work, in seconds."""
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "bound_by": bound_by,
            "library_ms": library_ms}


def upload_mate(codes, L, dev):
    """One mate's [B, READ_LEN] codes padded to L, 2-bit packed, on the
    card: (packed, bad, lengths)."""
    import numpy as np
    import torch

    from seekmer_tpu_torch.encoding import pack_codes_2bit

    padded = np.full((codes.shape[0], L), 4, np.uint8)
    padded[:, :READ_LEN] = codes
    packed, bad = pack_codes_2bit(padded)
    return (torch.from_numpy(packed).to(dev), torch.from_numpy(bad).to(dev),
            torch.full((codes.shape[0],), READ_LEN, dtype=torch.int32,
                       device=dev))


def check_lookup(tag, index, di, hi, lo, valid):
    """K2 against its plain version on one batch's lanes, timed; returns
    its record. The bound counts what the function must read of the table
    at the card's 32-byte sector grain: the hi slab (4 G bytes) of each
    distinct home row of a valid key, and the lo and ecaux sectors (2 x 32
    bytes) of each distinct key found; stash probes (keys absent from a
    full row) are not counted. PR 1-3 counted three whole slabs (hi, lo,
    ecaux) of each distinct home row; that figure is printed beside it."""
    import torch

    from seekmer_tpu_torch.ops import probe_cuda
    from seekmer_tpu_torch.ops.hash import hash_kmer

    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    got = probe_cuda.lookup_ecs_aux(hi, lo, valid, *geo)
    ref = probe_cuda.plain(hi, lo, valid, *geo)
    err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
    hits = float((got[0] >= 0).float().mean())
    check(hits > 0.3, f"K2 {tag} hit fraction {hits:.3f} is implausibly low")
    homes = hash_kmer(hi[valid], lo[valid]) & (index.main_slots // di.bucket
                                               - 1)
    rows = int(torch.unique(homes).numel())
    found = got[0] >= 0
    keys = int(torch.unique((hi[found].to(torch.int64) << 32)
                            | (lo[found].to(torch.int64) & 0xFFFFFFFF))
               .numel())
    io = nbytes(hi, lo, valid, *got)
    slab = 4 * di.bucket
    rec = record(
        err, cuda_ms(lambda: probe_cuda.lookup_ecs_aux(hi, lo, valid, *geo),
                     20),
        cuda_ms(lambda: probe_cuda.plain(hi, lo, valid, *geo), 3),
        (io + rows * slab + keys * 64) / HBM_BYTES_S, "bytes")
    slabs3_ms = (io + rows * 3 * slab) / HBM_BYTES_S * 1e3
    # what the kernel itself reads, lane by lane with no reuse: the hi slab
    # of every valid key, and the lo and ecaux sectors of every found one
    # (at 32 bytes each, or at the 64-byte grain of a device-memory access)
    n_valid, n_found = int(valid.sum()), int(found.sum())
    own = [(io + n_valid * slab + n_found * 2 * grain) / HBM_BYTES_S * 1e3
           for grain in (32, 64)]
    log(f"[K2 lookup {tag}] {hi.numel()} lanes ({n_valid} valid, {n_found} "
        f"found) against {index.num_kmers} k-mers (hit fraction {hits:.4f}, "
        f"{rows} distinct home rows, {keys} distinct keys found): "
        f"max_abs_err {err}, kernel {rec['ms']:.6f} ms, plain "
        f"{rec['plain_ms']:.6f} ms, bound {rec['bound_ms']:.6f} ms (share "
        f"{rec['bound_ms'] / rec['ms']:.6f}; three slabs a row, as PR 1-3 "
        f"counted: {slabs3_ms:.6f} ms); the kernel's own reads, lane by "
        f"lane: {own[0]:.6f} ms at 32-byte sectors (kernel x"
        f"{rec['ms'] / own[0]:.3f}), {own[1]:.6f} ms at 64-byte accesses "
        f"(x{rec['ms'] / own[1]:.3f})")
    return rec, got


def log_heads(tag, ecs, valid) -> None:
    """K3's run-head histogram of one batch: the share of reads it serves
    from one 32-wide sort of their heads, and the largest head count."""
    from seekmer_tpu_torch.utils import kernel_ab

    h = kernel_ab.head_summary(ecs, valid)
    log(f"[K3 heads {tag}] {h['reads']} reads of {ecs.shape[1]} windows: "
        f"{h['share_le_32']:.6f} with <= 32 run heads (one 32-wide sort), "
        f"largest {h['max']}, mean {h['mean']:.3f}")


def check_sig_rows(dev) -> int:
    """K3 against its plain version on the rows of
    tests/synthetic_signatures.py (32 and 33 run heads, every window a head,
    ids recurring after a miss, ...) at W 256 and 1,024 and at P 101 (one
    window a load); returns the largest difference."""
    import numpy as np
    import torch

    from seekmer_tpu_torch.ops import sig_cuda
    from tests.synthetic_signatures import adversarial_rows

    err = 0
    for P in (208, 976, 101):
        ecs, valid = adversarial_rows(P, 16, seed=P)
        reps = 2048 // ecs.shape[0] + 1
        e = torch.from_numpy(np.tile(ecs, (reps, 1))).to(dev)
        v = torch.from_numpy(np.tile(valid, (reps, 1))).to(dev)
        got = sig_cuda.read_signatures(e, v, 16)
        ref = sig_cuda.plain(e, v, 16)
        err = max(err, *(max_abs_diff(g, r) for g, r in zip(got, ref)))
    return err


def check_forced_collision(sig, mapped, weights, num_ecs) -> int:
    """A1 against its plain version on tables pre-seeded with a colliding
    key for one multi-EC signature of the batch (another row stored under
    its fingerprint), folded twice with the audit on: the collisions must
    agree and be > 0. Returns the largest difference after the merge."""
    import numpy as np

    from seekmer_tpu_torch.map.driver import merge_sig_rows
    from seekmer_tpu_torch.map.signature import (SIG_PAD, make_sig_table,
                                                 table_to_host)
    from seekmer_tpu_torch.ops import accumulate_cuda
    from tests.synthetic_signatures import seed_collision

    x = sig[mapped & (sig[:, 1] != SIG_PAD)][0]
    merged = []
    for fold in (accumulate_cuda.fold_batch, accumulate_cuda.plain):
        t = make_sig_table(22, sig.shape[1], num_ecs=num_ecs,
                           device=sig.device)
        seed_collision(t, x)
        for _ in range(2):
            fold(t, sig, mapped, weights=weights)
        s, c = table_to_host(t)
        merged.append(merge_sig_rows(s, c, 0, int(t.overflow),
                                     int(t.collisions)))
    mk, mp = merged
    check(np.array_equal(mk.sigs, mp.sigs), "A1 merged signatures differ "
          "on the colliding table")
    check(mk.collisions > 0, "A1: the seeded collision was not counted")
    log(f"[A1 accumulate] pre-seeded colliding table, two folds: collisions "
        f"{mk.collisions} (plain {mp.collisions})")
    return max(int(np.abs(mk.sig_counts - mp.sig_counts).max(initial=0)),
               abs(mk.collisions - mp.collisions),
               abs(mk.overflow - mp.overflow))


def check_fast(tag, di, mates, L, stride, dense):
    """K5 and K6 against their plain versions on one batch at one stride,
    each timed beside the bytes it must move (device time with the card
    kept busy while the host enqueues, ``utils/kernel_ab.py``; K5 without
    the unit count's readback): K5 its 2-bit rows, its outputs and, by K2's
    model, the hi slab of each distinct home row of a valid sampled key and
    two 32-byte sectors of each distinct key found; K6 its inputs and the
    signatures. Prints the resolved-read and fallback-unit fractions and
    checks every fast signature against ``dense`` (sig, mapped of the dense
    route on the same reads): equal, or a non-empty subset, wherever the
    dense row is whole (mapped, or empty). Returns the two records."""
    import torch

    from seekmer_tpu_torch.map.signature import SIG_PAD
    from seekmer_tpu_torch.ops import (accumulate_cuda, fast_cuda, pack_cuda,
                                       probe, probe_cuda, sig_cuda)
    from seekmer_tpu_torch.ops.hash import hash_kmer
    from seekmer_tpu_torch.utils import kernel_ab

    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    k, C = di.k, dense[0].shape[1]
    B, n_seg = mates[0][0].shape[0], len(mates)
    single, slot, units = fast_cuda.sample_classify(mates, L, k, stride,
                                                    *geo)
    want = probe.sample_classify(mates, L, k, stride, *geo)
    has = slot >= 0
    nu = units[0].shape[0]
    check(nu == want[2][0].shape[0], f"K5 {tag}: {nu} units, plain "
          f"{want[2][0].shape[0]}")
    err5 = max(max_abs_diff(single, want[0]),
               max_abs_diff(has, want[1] >= 0),
               *(max_abs_diff(g[slot[has].long()], w[want[1][has].long()])
                 for g, w in zip(units, want[2])))
    if nu:
        hi, lo, valid = pack_cuda.pack_canonical_2bit(*units, L, k)
        sig_d, mapped_d = sig_cuda.read_signatures(
            probe_cuda.lookup_ecs(hi, lo, valid, *geo), valid, C)
    else:
        sig_d = torch.empty((0, C), dtype=torch.int32, device=single.device)
        mapped_d = torch.empty(0, dtype=torch.bool, device=single.device)
    merge_args = (single, slot, sig_d, mapped_d, C)
    fs, fm = fast_cuda.merge_staging(*merge_args)
    err6 = max(max_abs_diff(a, b) for a, b in
               zip((fs, fm), probe.merge_staging(*merge_args)))
    check(err5 == 0 and err6 == 0, f"fast mode {tag} s={stride}: K5 "
          f"max_abs_err {err5}, K6 {err6}")

    # K2's byte model over the valid sampled keys
    cols = probe.sample_columns(L - k + 1, stride)
    keys = [t[:, cols] for m in mates for t in pack_cuda.plain(*m, L, k)]
    hs = torch.cat([h[v] for h, v in zip(keys[0::3], keys[2::3])])
    ls = torch.cat([x[v] for x, v in zip(keys[1::3], keys[2::3])])
    rows = int(torch.unique(hash_kmer(hs, ls)
                            & (di.main_slots // di.bucket - 1)).numel())
    found = probe.lookup_ecs(hs, ls, torch.ones_like(hs, dtype=torch.bool),
                             *geo) >= 0
    nkeys = int(torch.unique((hs[found].to(torch.int64) << 32)
                             | (ls[found].to(torch.int64) & 0xFFFFFFFF))
                .numel())
    Sp, Sb = (L + 3) // 4, (L + 7) // 8
    io5 = (nbytes(*(t for m in mates for t in m), single, slot) + 4
           + nu * (Sp + Sb + 4))
    def k5_launch():
        fast_cuda.launch_sample(mates, L, k, stride, *geo)

    def k6_launch():
        fast_cuda.merge_staging(*merge_args)

    # K5's lookup floor: K2 on exactly its valid sampled keys; K6's: an
    # empty kernel on its grid
    every = torch.ones_like(hs, dtype=torch.bool)
    k2_same = kernel_ab.device_ms(
        lambda: probe_cuda.lookup_ecs_aux(hs, ls, every, *geo), 50)
    k6_floor = kernel_ab.device_ms(  # A1's grid is K6's: 256 reads a block
        lambda: accumulate_cuda.empty_launch(B, single.device, False), 50)

    k5 = record(err5, kernel_ab.device_ms(k5_launch, 50),
                cuda_ms(lambda: probe.sample_classify(mates, L, k, stride,
                                                      *geo), 3),
                (io5 + rows * 4 * di.bucket + nkeys * 64) / HBM_BYTES_S,
                "bytes")
    k6 = record(err6, kernel_ab.device_ms(k6_launch, 50),
                cuda_ms(lambda: probe.merge_staging(*merge_args), 10),
                (nbytes(single, slot, sig_d, mapped_d, fs, fm))
                / HBM_BYTES_S, "bytes")
    times = {name: (cuda_ms(fn, 50), kernel_ab.host_us(fn, 50))
             for name, fn in (("K5", k5_launch), ("K6", k6_launch))}

    resolved = float((~has.any(dim=1) & (single != SIG_PAD).any(dim=1))
                     .float().mean())
    ds, dm = dense
    inside = ((fs == SIG_PAD)
              | (fs[:, :, None] == ds[:, None, :]).any(dim=2)).all(dim=1)
    equal = (fs == ds).all(dim=1)
    whole = dm | (ds[:, 0] == SIG_PAD)
    bad = int((whole & ~(inside & (equal | (fs[:, 0] != SIG_PAD)))).sum())
    check(bad == 0, f"fast mode {tag} s={stride}: {bad} fast signatures are "
          "neither the dense one nor a non-empty subset of it")
    log(f"[fast {tag} s={stride}] {B} reads x {n_seg} segments, {len(cols)} "
        f"sampled columns a segment: resolved in phase 1 {resolved:.6f}, "
        f"fallback units {nu} ({nu / (B * n_seg):.6f}); mapped {int(fm.sum())}"
        f" (dense {int(dm.sum())}); fast signature equal to the dense one "
        f"{float(equal.float().mean()):.6f}, a strict subset "
        f"{int((inside & ~equal & whole).sum())}, dense row not whole "
        f"{int((~whole).sum())}")
    plan = fast_cuda.sample_plan(L, k, stride, n_seg)
    for name, r, extra in (
            ("K5", k5, f"{hs.numel()} valid sampled lanes, {rows} distinct "
                       f"home rows, {nkeys} distinct keys found; K2 on the "
                       f"same valid keys {k2_same:.6f} ms (K5 x"
                       f"{k5['ms'] / k2_same:.3f} of it); a warp {plan.reads}"
                       f" reads, {plan.S} sampled columns a segment"),
            ("K6", k6, f"{nu} unit rows; empty launch of its grid "
                       f"{k6_floor:.6f} ms")):
        log(f"[{name} {tag} s={stride}] max_abs_err {r['max_abs_err']}, "
            f"kernel {r['ms']:.6f} ms (device time; back to back "
            f"{times[name][0]:.6f} ms, host enqueue {times[name][1]:.3f} "
            f"us), plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} "
            f"ms (share {r['bound_ms'] / r['ms']:.6f}); {extra}")
    return k5, k6


def check_strided(tag, di, hi, lo, valid, dense, stride, segments):
    """K7 against its plain version on one batch's windows ([B, W], W =
    segments x P; a pair's mates are two segments), bit for bit, and
    against K2's result ``dense`` on the same windows: every dense hit
    equal, every difference a fill over a dense miss, invalid windows MISS.
    Timed (device time with the card kept busy) beside K2 on the whole
    batch and on exactly the keys K7 looks up: each segment's valid sampled
    windows (P - 1 twice where it is a multiple of s, as K7 looks it up
    twice) and its needy windows. The bound counts, by K2's model, the hi
    slab of each distinct home row of those keys and two 32-byte sectors of
    each distinct key found, plus the 32-byte sectors of hi and lo that
    hold one of those windows, all of valid, and the ec write. Returns K7's
    record."""
    import torch

    from seekmer_tpu_torch.ops import probe, probe_cuda, strided_cuda
    from seekmer_tpu_torch.ops.hash import hash_kmer
    from seekmer_tpu_torch.utils import kernel_ab

    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    got = strided_cuda.lookup_ecs_strided(hi, lo, valid, *geo, stride,
                                          segments=segments)
    err = max_abs_diff(got, strided_cuda.plain(hi, lo, valid, *geo, stride,
                                               segments))
    hit = valid & (dense >= 0)
    div = valid & (got != dense)
    check(err == 0, f"K7 {tag} s={stride}: max_abs_err {err}")
    check(torch.equal(got[hit], dense[hit]) and bool((dense[div] == -1).all())
          and bool((got[div] >= 0).all()) and bool((got[~valid] == -1).all()),
          f"K7 {tag} s={stride}: breaks the dense invariants against K2")

    B, W = hi.shape
    P = W // segments
    h, l_, v = (x.reshape(B * segments, P) for x in (hi, lo, valid))
    cols = torch.tensor(probe.strided_columns(P, stride), device=hi.device)
    _, need = probe.strided_fill(h, l_, v, *geo, stride)
    vs = v[:, cols]
    hs = torch.cat([h[:, cols][vs], h[need]])
    ls = torch.cat([l_[:, cols][vs], l_[need]])
    # hi and lo are read only at those windows: their distinct sectors of
    # 8 int32 (both contiguous, so window c of segment row r is r P + c)
    flat = torch.arange(h.numel(), device=hi.device).reshape(h.shape)
    sectors = int(torch.unique(torch.cat([flat[:, cols][vs], flat[need]])
                               // 8).numel())
    every = torch.ones_like(hs, dtype=torch.bool)
    rows = int(torch.unique(hash_kmer(hs, ls)
                            & (di.main_slots // di.bucket - 1)).numel())
    found = probe.lookup_ecs(hs, ls, every, *geo) >= 0
    nkeys = int(torch.unique((hs[found].to(torch.int64) << 32)
                             | (ls[found].to(torch.int64) & 0xFFFFFFFF))
                .numel())
    n_valid, n_samp, n_need = int(valid.sum()), int(vs.sum()), int(need.sum())
    rec = record(
        err, kernel_ab.device_ms(lambda: strided_cuda.lookup_ecs_strided(
            hi, lo, valid, *geo, stride, segments=segments), 50),
        cuda_ms(lambda: strided_cuda.plain(hi, lo, valid, *geo, stride,
                                           segments), 3),
        (2 * 32 * sectors + nbytes(valid, got) + rows * 4 * di.bucket
         + nkeys * 64) / HBM_BYTES_S, "bytes")
    k2_whole = kernel_ab.device_ms(
        lambda: probe_cuda.lookup_ecs_aux(hi, lo, valid, *geo), 50)
    k2_same = kernel_ab.device_ms(
        lambda: probe_cuda.lookup_ecs_aux(hs, ls, every, *geo), 50)
    log(f"[K7 strided {tag} s={stride}] {B} reads x {segments} segments of "
        f"{P} windows ({n_valid} valid), {cols.numel()} sampled columns a "
        f"segment: {n_samp} valid sampled keys, {n_need} needy windows "
        f"({n_need / max(n_valid, 1):.6f} of the valid), {int(div.sum())} "
        f"filled over a dense miss; max_abs_err {err}, kernel "
        f"{rec['ms']:.6f} ms (device time), plain {rec['plain_ms']:.6f} ms, "
        f"bound {rec['bound_ms']:.6f} ms (share "
        f"{rec['bound_ms'] / rec['ms']:.6f}; {rows} distinct home rows, "
        f"{nkeys} distinct keys found, {sectors} of {-(-h.numel() // 8)} "
        f"sectors of hi and of lo); K2 on the whole batch "
        f"{k2_whole:.6f} ms (K7 x{rec['ms'] / k2_whole:.3f}), K2 on exactly "
        f"K7's {hs.numel()} keys {k2_same:.6f} ms (K7 x"
        f"{rec['ms'] / k2_same:.3f})")
    sms = torch.cuda.get_device_properties(hi.device).multi_processor_count
    plan = strided_cuda.strided_plan(P, stride, B * segments, sms)
    resident = strided_cuda.resident_warps(sms, plan.blocks)
    vec4 = P % 4 == 0
    regs, spill = build_info(f"strided_kernelILi{di.bucket}ELb{int(vec4)}E")
    log(f"[K7 strided {tag} s={stride} tiles] a tile {plan.segs} segments, "
        f"{-(-B * segments // plan.segs)} tiles, resident warps {resident} "
        f"({plan.blocks} blocks an SM of {strided_cuda.WARPS} warps), "
        f"staging 2 x {plan.stage} bytes of {plan.warp_bytes} a warp, "
        f"{'4 windows' if vec4 else 'one window'} a lane; kernel "
        f"(G={di.bucket}) {regs} registers, {spill} spill bytes")
    return rec


def build_info(name: str):
    """(registers, spill store + load bytes) of the kernel whose mangled
    name holds ``name``, from the ``-Xptxas -v`` report of the loaded
    library's build."""
    from seekmer_tpu_torch.ops import _build

    regs = spill = None
    current = False
    for line in _build.log_path().read_text().splitlines():
        if "Compiling entry function" in line:
            current = name in line
        elif current and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = nums[1] + nums[2]  # stack frame, stores, loads
        elif current and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split()[0])
    check(regs is not None and spill is not None,
          f"no ptxas report of {name} in {_build.log_path().name}")
    return regs, spill


def readback_gap(step, reps: int = 10) -> None:
    """Trace ``reps`` calls of the fast map step with ``torch.profiler`` and
    print the card's idle time between each K5's end and the start of the
    next kernel (the unit count's readback lies between them), and the
    device-to-host copy inside that gap, over the K5 launches the trace
    holds (a trace may lose some); fails only when it holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    ev = sorted(((e.time_range.start, e.time_range.end, e.name)
                 for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda t: t[0])
    gaps, copies = [], []
    for i, (_, end, name) in enumerate(ev):
        if "sample_kernel" not in name:
            continue
        later = [e for e in ev[i + 1:]
                 if "emcpy" not in e[2] and "emset" not in e[2]]
        if not later:  # the trace lost the kernel after this K5
            continue
        copy = [e for e in ev[i + 1:] if "emcpy" in e[2] and e[0] >= end]
        gaps.append(later[0][0] - end)
        if copy and copy[0][0] < later[0][0]:
            copies.append(copy[0][1] - copy[0][0])
    check(bool(gaps), "the fast map step trace holds no K5 launch followed "
          "by a kernel")
    log(f"[map step fast s=16 readback] card idle from K5's end to the next "
        f"kernel's start, over the {len(gaps)} K5 launches of {reps} traced "
        f"steps that the trace holds with a kernel after them: mean "
        f"{sum(gaps) / len(gaps):.3f} us, min {min(gaps):.3f}, max "
        f"{max(gaps):.3f} (the unit count's device-to-host copy inside it: "
        f"{len(copies)} copies, mean "
        f"{sum(copies) / max(len(copies), 1):.3f} us)")


def a1_tables_diff(tables, B: int, what: str):
    """Two A1 tables folded from the same rows (the kernel's, then the
    plain version's): their merged signatures and fingerprint keys must be
    equal. Returns the largest difference of counts, overflow and
    collisions, and the kernel table's MapResult."""
    import numpy as np
    import torch

    from seekmer_tpu_torch.map.driver import merge_sig_rows
    from seekmer_tpu_torch.map.signature import table_to_host

    mk, mp = (merge_sig_rows(*table_to_host(t), B, int(t.overflow),
                             int(t.collisions)) for t in tables)
    check(np.array_equal(mk.sigs, mp.sigs), f"{what}: merged signatures "
          "differ")
    keys = [np.sort(t.key.view(torch.int64).cpu().numpy().ravel())
            for t in tables]
    check(np.array_equal(*keys), f"{what}: fingerprint keys differ")
    err = int(np.abs(mk.sig_counts - mp.sig_counts).max(initial=0))
    return max(err, abs(mk.overflow - mp.overflow),
               abs(mk.collisions - mp.collisions)), mk


def check_route(hi, lo, valid, di, want):
    """``[R1 route ...]``, ``[R2 unroute ...]``: the routing kernels on the
    first half of a paired config-2 batch (a rank's rows at 2 ranks), at 2
    owners and again at 4 on the same lanes, every round's slab looked up
    by K2 on the whole table. At capacity factor 2 (one round): R1's
    counts equal to its plain version's; each owner's round-0 slots hold
    min(count, K) distinct valid lanes of that owner with their hi and lo;
    R2 equal to its plain version; the lanes' ECs equal to K2 on the lanes
    themselves. At a capacity of three rounds: each owner's round-0 lanes
    and spilled lanes disjoint and together exactly its valid lanes, the
    spilled ranks K..count-1; each later round's filled slots equal to the
    plain ``route_spill`` on the kernel's own spill list; the ECs equal to
    K2's, and a second run's bits equal (the lanes that spill may differ).
    R1's time is its one-round call, bounded by the function's bytes: hi,
    lo and valid in, the routed lanes' slab out; R2's moves a filled
    slot's EC and index in and its lane's EC out, beside ``index_put_`` of
    the same values; the spill entry's is a later round's at the three
    rounds' capacity. Device times, card kept busy. Returns the (R1, R2)
    records at 2 owners, their errors the larger of both passes'."""
    half = hi.shape[0] // 2
    hi, lo, valid = (t[:half].reshape(-1) for t in (hi, lo, valid))
    want = want[:half].reshape(-1)
    r1, r2 = route_pass(hi, lo, valid, di, want, 2, half)
    r1_4, r2_4 = route_pass(hi, lo, valid, di, want, 4, half)
    r1["max_abs_err"] = max(r1["max_abs_err"], r1_4["max_abs_err"])
    r2["max_abs_err"] = max(r2["max_abs_err"], r2_4["max_abs_err"])
    return r1, r2


def route_pass(hi, lo, valid, di, want, D, half):
    """One pass of ``check_route`` at D owners on a rank's flat lanes;
    returns its (R1, R2) records."""
    import torch

    from seekmer_tpu_torch.ops import probe_cuda, route, route_cuda
    from seekmer_tpu_torch.ops.hash import hash_kmer
    from seekmer_tpu_torch.parallel.prefix_shard import capacity
    from seekmer_tpu_torch.utils import kernel_ab

    N = hi.numel()
    dev = hi.device
    geo = (di.table, di.main_slots, di.stash, di.stash_slots, di.bucket)
    owner = torch.where(valid, hash_kmer(hi, lo) >> (32 - route.owner_bits(D)),
                        D)
    tag = "config 2" if D == 2 else f"config 2 D={D}"

    def lookup(K):
        """Every round at capacity K: (ECs, round 0's slab, counts, the
        spill list's written part, rounds, the largest difference of a
        later round's filled slots from the plain ``route_spill`` on the
        kernel's own spill list)."""
        *slab0, counts, spill = route_cuda.route_first(hi, lo, valid, D, K)
        n_spill = int((counts.long() - K).clamp(min=0).sum())
        rounds = -(-int(counts.max()) // K)
        ecs = torch.full((N,), -1, dtype=torch.int32, device=dev)
        slab, err = slab0, 0
        for j in range(rounds):
            f = route.filled(counts, j * K, K)
            if j:
                slab = route_cuda.route_spill(hi, lo, spill, n_spill, D,
                                              j * K, K)
                p_slab = route.route_spill(hi, lo, spill, n_spill, D, j * K,
                                           K)
                err = max([err] + [max_abs_diff(a[f], b[f])
                                   for a, b in zip(slab, p_slab)])
            ec_q = probe_cuda.lookup_ecs(slab[0], slab[1], f, *geo)
            route_cuda.unroute(ec_q, slab[2], counts, j * K, K, ecs)
        return ecs, slab0, counts, spill[:, :n_spill].long(), rounds, err

    def round0(slab0, counts, K):
        """Each owner's round-0 lanes, checked."""
        f = route.filled(counts, 0, K)
        lanes = slab0[2][f].long()
        check(torch.equal(slab0[0][f], hi[lanes])
              and torch.equal(slab0[1][f], lo[lanes]),
              f"[R1 route {tag}] a round-0 slot's hi or lo is not its lane's")
        of = torch.arange(D * K, device=dev)[f] // K  # a slot's owner
        out = []
        for d in range(D):
            mine = lanes[of == d]
            check(mine.numel() == min(int(counts[d]), K)
                  and torch.unique(mine).numel() == mine.numel()
                  and bool((owner[mine] == d).all()),
                  f"[R1 route {tag}] owner {d}'s round-0 slots are not "
                  f"min(count, K) distinct lanes of that owner")
            out.append(mine)
        return out

    # one round, as the [ps] phase routes a config-2 batch
    K = capacity(N, D, 2.0)
    ecs, slab0, counts, _, rounds, _ = lookup(K)
    p_counts = route.route_first(hi, lo, valid, D, K)[3]
    err = max_abs_diff(counts, p_counts)
    check(err == 0 and rounds == 1, f"[R1 route {tag}] counts "
          f"{counts.tolist()} != the plain version's {p_counts.tolist()}, "
          f"or {rounds} rounds")
    round0(slab0, counts, K)
    f = route.filled(counts, 0, K)
    ec_q = probe_cuda.lookup_ecs(slab0[0], slab0[1], f, *geo)
    empty = torch.full((N,), -1, dtype=torch.int32, device=dev)
    ecs2 = route_cuda.unroute(ec_q, slab0[2], counts, 0, K, empty.clone())
    err2 = max(max_abs_diff(ecs2, route.unroute(ec_q, slab0[2], counts, 0, K,
                                                empty.clone())),
               max_abs_diff(ecs2, want))
    err = max(err, max_abs_diff(ecs, want))
    routed = int(counts.sum())

    # three rounds: round 0 and the spill list split each owner's lanes
    K3 = -(-int(counts.max()) // 3)
    runs = [lookup(K3) for _ in range(2)]
    for ecs3, slab3, counts3, spill3, rounds3, err3 in runs:
        check(rounds3 == 3, f"[R1 route {tag}] K {K3} took {rounds3} rounds")
        err = max(err, err3, max_abs_diff(ecs3, want))
        for d, first in enumerate(round0(slab3, counts3, K3)):
            spilled = spill3[0][spill3[1] == d]
            check(torch.equal(torch.sort(spill3[2][spill3[1] == d]).values,
                              torch.arange(K3, int(counts3[d]), device=dev))
                  and torch.equal(torch.sort(torch.cat([first, spilled]))
                                  .values,
                                  torch.nonzero(owner == d).squeeze(1)),
                  f"[R1 route {tag}] owner {d}: round 0 and the spill list "
                  f"are not a split of its valid lanes")
    check(torch.equal(runs[0][0], runs[1][0]),
          f"[R1 route {tag}] two three-round runs gave different ECs")
    same_spill = torch.equal(torch.sort(runs[0][3][0]).values,
                             torch.sort(runs[1][3][0]).values)
    spill_ms = kernel_ab.device_ms(lambda: route_cuda.route_spill(
        hi, lo, runs[0][3].int().contiguous(), runs[0][3].shape[1], D, K3,
        K3), 50)

    out1 = record(
        err, kernel_ab.device_ms(
            lambda: route_cuda.route_first(hi, lo, valid, D, K), 50),
        cuda_ms(lambda: route.route_first(hi, lo, valid, D, K), 5),
        (9 * N + 12 * routed + 4 * D) / HBM_BYTES_S, "bytes")
    idx, vals = slab0[2][f].long(), ec_q[f]
    out2 = record(
        err2, kernel_ab.device_ms(lambda: route_cuda.unroute(
            ec_q, slab0[2], counts, 0, K, ecs2), 50),
        cuda_ms(lambda: route.unroute(ec_q, slab0[2], counts, 0, K, ecs2),
                10),
        12 * routed / HBM_BYTES_S, "bytes",
        kernel_ab.device_ms(lambda: ecs2.index_put_((idx,), vals), 50))
    log(f"[R1 route {tag}] {N} lanes ({half} pairs x {N // half}"
        f" windows), {D} owners, K {K}: counts {counts.tolist()} "
        f"({routed} valid lanes), max_abs_err {err} (counts; the spill "
        f"entry's filled slots against the plain route_spill on the "
        f"kernel's spill list; every lane's EC against K2 on the lanes, "
        f"one round and three); each owner's "
        f"round-0 slots min(count, K) distinct lanes of its own; at K {K3}, "
        f"3 rounds, round 0 and {runs[0][3].shape[1]} spilled lanes split "
        f"each owner's lanes, a second run's ECs bit-equal (its spilled "
        f"lanes {'the same' if same_spill else 'others'}); one round "
        f"{out1['ms']:.6f} ms (device time, card kept busy; one launch and "
        f"the counts' memset), a later round's spill entry at K {K3} "
        f"{spill_ms:.6f} ms, plain {out1['plain_ms']:.6f} ms, bound "
        f"{out1['bound_ms']:.6f} ms (share "
        f"{out1['bound_ms'] / out1['ms']:.6f})")
    log(f"[R2 unroute {tag}] {D * K} slots, {routed} filled: max_abs_err "
        f"{err2} (against its plain version and K2 on the lanes "
        f"themselves), kernel {out2['ms']:.6f} ms (device time, card kept "
        f"busy), plain {out2['plain_ms']:.6f} ms, index_put_ "
        f"{out2['library_ms']:.6f} ms (device time), bound "
        f"{out2['bound_ms']:.6f} ms (share "
        f"{out2['bound_ms'] / out2['ms']:.6f})")
    return out1, out2


def compare_kernels(work: Path, batches, keep_inputs=None):
    """Each kernel against its plain version at one paired config-2 batch's
    shapes, with the bytes each must move at the least (each input read
    once, each output written once; for the table kernels, what this
    batch needs of the table); K2 also on one config-1 batch, whose table
    mostly sits in L2. No single PyTorch call computes any of these
    functions, so none has a library time. Also times the device map step
    on one pre-uploaded batch of each world, dense and fast at s = 16.
    Returns ({name: record}, {"c1" | "c1 fast" | "c2" | "c2 fast": step
    ms})."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.map.driver import (DeviceIndex, map_step,
                                              merge_sig_rows)
    from seekmer_tpu_torch.map.signature import make_sig_table, table_to_host
    from seekmer_tpu_torch.ops import (accumulate_cuda, pack_cuda, probe,
                                       sig_cuda)
    from seekmer_tpu_torch.utils import kernel_ab

    dev = torch.device(DEVICE)
    L = 128  # 100 bp reads sit in the 128 length bucket
    out = {}

    # K2 on config 1 first: its table leaves the card before config 2's
    index = load_index(work, "c1")
    di = DeviceIndex.from_host(index, dev)
    c1_lanes = pack_cuda.pack_canonical_2bit(
        *upload_mate(batches[0], L, dev), L, index.k)
    c1, c1_got = check_lookup("config 1", index, di, *c1_lanes)
    log_heads("config 1", c1_got[0], c1_lanes[2])
    check_strided("config 1", di, *c1_lanes, c1_got[0], 4, 1)
    for stride in (16, 2):
        check_fast("config 1", di, [upload_mate(batches[0], L, dev)], L,
                   stride, sig_cuda.read_signatures(c1_got[0], c1_lanes[2],
                                                    16))
    # the device map step on the pre-uploaded config-1 batch (K1, K2, K3,
    # A1 with the audit; fast: K5, the readback, K1-K3 on the units, K6,
    # A1): the numerators of [baseline c1]'s step ratios
    steps = {}
    mate = upload_mate(batches[0], L, dev)
    table = make_sig_table(20, 16, num_ecs=index.num_ecs, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    for tag, sample in (("c1", 0), ("c1 fast", 16)):
        cfg = MapConfig(batch_size=B, probe_sample=sample)
        steps[tag] = cuda_ms(lambda cfg=cfg: map_step(
            di, cfg, table, mate[0], mate[2], ones, bad=mate[1], pad_len=L,
            audit=True), 20)
        log(f"[map step config 1{' fast s=16' if sample else ''}] one "
            f"batch on the card: {steps[tag]:.6f} ms, "
            f"{B / steps[tag] * 1e3:.0f} reads/s of device time")
    del di, c1_lanes, c1_got, mate, table

    index = load_index(work, "c2")
    di = DeviceIndex.from_host(index, dev)
    k = index.k
    mates = [upload_mate(codes, L, dev) for codes in batches[1]]
    p, bd, ln = mates[0]
    got = pack_cuda.pack_canonical_2bit(p, bd, ln, L, k)
    ref = pack_cuda.plain(p, bd, ln, L, k)
    err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
    out["K1"] = record(
        err, cuda_ms(lambda: pack_cuda.pack_canonical_2bit(p, bd, ln, L, k),
                     200),
        cuda_ms(lambda: pack_cuda.plain(p, bd, ln, L, k), 10),
        nbytes(p, bd, ln, *got) / HBM_BYTES_S, "bytes")
    log(f"[K1 pack] [{B}, {L}] k={k}: max_abs_err {err}, kernel "
        f"{out['K1']['ms']:.6f} ms, plain {out['K1']['plain_ms']:.6f} ms, "
        f"bound {out['K1']['bound_ms']:.6f} ms (share "
        f"{out['K1']['bound_ms'] / out['K1']['ms']:.6f})")

    # both mates into one (B, 2P) output, as the map step packs them
    P = L - k + 1
    joined = tuple(torch.empty((B, 2 * P), dtype=dt, device=dev)
                   for dt in (torch.int32, torch.int32, torch.bool))
    for i, m in enumerate(mates):
        pack_cuda.pack_canonical_2bit(*m, L, k, out=joined, offset=i * P)
    apart = [pack_cuda.plain(*m, L, k) for m in mates]
    err = max(max_abs_diff(j, torch.cat([a, b], dim=1))
              for j, a, b in zip(joined, *apart))
    out["K1"]["max_abs_err"] = max(out["K1"]["max_abs_err"], err)
    log(f"[K1 pack] both mates into one [{B}, {2 * P}] output: max_abs_err "
        f"{err} against the plain versions' concatenation")

    hi, lo, valid = joined
    out["K2"], got = check_lookup("config 2", index, di, hi, lo, valid)
    check(c1["max_abs_err"] == 0, "K2 disagrees with its plain version on "
          f"config 1: {c1['max_abs_err']}")
    ecs = got[0]
    out["R1"], out["R2"] = check_route(hi, lo, valid, di, ecs)
    C = 16
    if keep_inputs:
        torch.save({"ecs": ecs.cpu(), "valid": valid.cpu(), "max_ecs": C,
                    "num_ecs": index.num_ecs,
                    "fast": {"mates": [tuple(t.cpu() for t in m)
                                       for m in mates],
                             "table": di.table.cpu(), "stash": di.stash.cpu(),
                             "main_slots": di.main_slots,
                             "stash_slots": di.stash_slots,
                             "bucket": di.bucket, "L": L, "k": k,
                             "max_ecs": C, "strides": [16, 8]},
                    # R1's: a rank's half of the batch at 2 owners
                    "route": {"hi": hi[:B // 2].cpu(), "lo": lo[:B // 2].cpu(),
                              "valid": valid[:B // 2].cpu(), "D": 2}},
                   keep_inputs)
    log_heads("config 2", ecs, valid)
    got = sig_cuda.read_signatures(ecs, valid, C)
    ref = sig_cuda.plain(ecs, valid, C)
    err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
    err = max(err, check_sig_rows(dev))
    k3 = kernel_ab.time_k3(ecs, valid, C)
    out["K3"] = record(
        err, k3["ms"], cuda_ms(lambda: sig_cuda.plain(ecs, valid, C), 10),
        nbytes(ecs, valid, *got) / HBM_BYTES_S, "bytes")
    log(f"[K3 signature] [{B}, {ecs.shape[1]}] C={C}: max_abs_err {err} "
        f"(this batch and the adversarial rows), kernel "
        f"{out['K3']['ms']:.6f} ms (device time; back to back "
        f"{cuda_ms(lambda: sig_cuda.read_signatures(ecs, valid, C), 50):.6f}"
        f" ms), host enqueue {k3['host_us']:.3f} us, plain "
        f"{out['K3']['plain_ms']:.6f} ms, bound {out['K3']['bound_ms']:.6f} ms"
        f" (share {out['K3']['bound_ms'] / out['K3']['ms']:.6f})")

    # fusion mode's K3: a signature a mate side by side, mapped the AND
    got2 = sig_cuda.read_signatures(ecs, valid, C, segments=2)
    err2 = max(max_abs_diff(g, r) for g, r in
               zip(got2, sig_cuda.plain(ecs, valid, C, 2)))
    out["K3"]["max_abs_err"] = max(out["K3"]["max_abs_err"], err2)
    seg_ms = kernel_ab.device_ms(
        lambda: sig_cuda.read_signatures(ecs, valid, C, segments=2), 50)
    log(f"[K3 segments=2 config 2] [{B}, {ecs.shape[1]}] as two mates of "
        f"{P} windows, C={C} each: max_abs_err {err2}, kernel {seg_ms:.6f} ms "
        f"(device time; dense K3 on the same rows {k3['ms']:.6f} ms), "
        f"mapped {int(got2[1].sum())} (dense {int(got[1].sum())}), bound "
        f"{nbytes(ecs, valid, *got2) / HBM_BYTES_S * 1e3:.6f} ms")

    # fusion mode's A1: those signatures into a 2C-wide table with no
    # per-EC vector (num_ecs=0), so every read takes the CAS route, as in
    # fuse; held to the plain version as the dense fold is below
    weights = torch.ones(B, dtype=torch.int32, device=dev)

    def fresh_fused():
        return make_sig_table(22, 2 * C, num_ecs=0, device=dev)

    fused = []
    for fold in (accumulate_cuda.fold_batch, accumulate_cuda.plain):
        t = fresh_fused()
        fold(t, *got2, weights=weights, audit=True)
        fused.append(t)
    fused_err, fm = a1_tables_diff(fused, B, "A1 at fusion width")
    S = fused[0].count.numel() - 1
    fill = int((fused[0].count[:S] > 0).sum())
    fused_ms = kernel_ab.device_ms(
        lambda t: accumulate_cuda.fold_batch(t, *got2, weights=weights,
                                             audit=True), 20, fresh_fused)
    log(f"[A1 accumulate fusion width] {B} pairs into a [{S}, {2 * C}] "
        f"table with no per-EC vector: max_abs_err {fused_err}, "
        f"{fill} of {S} slots filled ({fill / S:.6f}), "
        f"{fm.sigs.shape[0]} distinct pair signatures, mapped {fm.mapped}, "
        f"overflow {fm.overflow}, collisions {fm.collisions}; claim + audit "
        f"on an empty table {fused_ms:.6f} ms (device time)")
    check(fm.overflow == 0, f"fusion table overflow {fm.overflow}")

    for stride in STRIDES:
        rec = check_strided("config 2", di, hi, lo, valid, ecs, stride, 2)
        if stride == 4:  # infer and fuse run at s = 4
            out["K7"] = rec

    sig, mapped = got
    out["K5"], out["K6"] = check_fast("config 2", di, mates, L, 16, got)
    for stride in (8, 2):
        check_fast("config 2", di, mates, L, stride, got)
    tables = []
    for fold in (accumulate_cuda.fold_batch, accumulate_cuda.plain):
        t = make_sig_table(22, C, num_ecs=index.num_ecs, device=dev)
        fold(t, sig, mapped, weights=weights)
        tables.append(t)
    err, mk = a1_tables_diff(tables, B, "A1")
    err = max(err, fused_err)
    multi = int(((sig[:, 1] != 0x7FFFFFFF) & mapped).sum())

    # first fold into an empty table: every distinct signature is claimed
    # (the reported time); the table is made outside the timed region
    def fresh():
        return make_sig_table(22, C, num_ecs=index.num_ecs, device=dev)

    # inputs, the per-read slot written, and each claimed table row (key,
    # count and signature row) written once; single-EC reads add their
    # direct counter
    multi_rows = int(torch.unique(sig[mapped & (sig[:, 1] != 0x7FFFFFFF)],
                                  dim=0).shape[0])
    single = int(torch.unique(sig[mapped & (sig[:, 1] == 0x7FFFFFFF), 0])
                 .numel())
    a1_bytes = (nbytes(sig, mapped, weights) + 4 * B
                + multi_rows * (8 + 4 + 4 * C) + single * 4)
    err = max(err, check_forced_collision(sig, mapped, weights,
                                          index.num_ecs))
    a1 = kernel_ab.time_a1(sig, mapped, weights, index.num_ecs)
    out["A1"] = record(
        err, a1["claim_audit_ms"],
        cuda_ms_each(fresh, lambda t: accumulate_cuda.plain(
            t, sig, mapped, weights=weights), 5),
        a1_bytes / HBM_BYTES_S, "bytes")
    # events around each call, the wrapper's host time included when it
    # exceeds what the card has queued (this kernel's earlier timing)
    events = cuda_ms_each(fresh, lambda t: accumulate_cuda.fold_batch(
        t, sig, mapped, weights=weights), 20)
    # steady state: the batch's signatures are already in both tables, so
    # every lane takes the matching path and none claims a slot
    steady_plain = cuda_ms(lambda: accumulate_cuda.plain(
        tables[1], sig, mapped, weights=weights), 5)
    log(f"[A1 accumulate] {B} reads ({multi} multi-EC) at sig_table_bits=22: "
        f"{mk.sigs.shape[0]} merged signatures, overflow {mk.overflow}, "
        f"collisions {mk.collisions}; max_abs_err {err} (this batch, the "
        f"fusion-width table and a pre-seeded colliding table); bound {out['A1']['bound_ms']:.6f} ms")
    log(f"[A1 accumulate] empty table (claims), device time: claim "
        f"{a1['claim_ms']:.6f} ms, claim + audit {a1['claim_audit_ms']:.6f} "
        f"ms (share {out['A1']['bound_ms'] / a1['claim_audit_ms']:.6f}); "
        f"steady state (matching path only): claim "
        f"{a1['steady_claim_ms']:.6f} ms, claim + audit "
        f"{a1['steady_claim_audit_ms']:.6f} ms, claim of the single-EC reads "
        f"alone {a1['steady_singles_only_ms']:.6f} ms, of the multi-EC reads "
        f"alone {a1['steady_multi_only_ms']:.6f} ms; empty launch of the "
        f"same grid {a1['floor_ms']:.6f} ms, cooperative "
        f"{a1['floor_coop_ms']:.6f} ms; host enqueue {a1['host_us']:.3f} us "
        f"with the audit, {a1['host_us_no_audit']:.3f} us without; events "
        f"around each call (host time included) {events:.6f} ms; plain "
        f"{out['A1']['plain_ms']:.6f} ms on an empty table, "
        f"{steady_plain:.6f} ms in steady state")
    for name, r in out.items():
        check(r["max_abs_err"] == 0,
              f"{name} disagrees with its plain version: {r['max_abs_err']}")

    # the whole device map step on one pre-uploaded paired batch (K1 x 2
    # into one output, K2, K3, A1 with the audit): the device's share of
    # the map stage, without ingest or upload
    cfg = MapConfig(batch_size=B, sig_table_bits=22, paired_end=True)
    step_ms = cuda_ms(lambda: map_step(
        di, cfg, tables[0], mates[0][0], mates[0][2], weights,
        codes2=mates[1][0], lengths2=mates[1][2], bad=mates[0][1],
        bad2=mates[1][1], pad_len=L, audit=True), 20)
    steps["c2"] = step_ms
    log(f"[map step] one paired batch on the card: {step_ms:.6f} ms, "
        f"{B / step_ms * 1e3:.0f} pairs/s of device time")
    # fast mode's step: K5, the unit count read back, K1, K2, K3 on the
    # units, K6, A1; its table against the plain route's on the same
    # tensors (every step's plain version, A1's too)
    for stride in (16, 8):
        fcfg = dataclasses.replace(cfg, probe_sample=stride)
        fast_ms = cuda_ms(lambda: map_step(
            di, fcfg, tables[0], mates[0][0], mates[0][2], weights,
            codes2=mates[1][0], lengths2=mates[1][2], bad=mates[0][1],
            bad2=mates[1][1], pad_len=L, audit=True), 20)
        if stride == 16:
            steps["c2 fast"] = fast_ms
        log(f"[map step fast s={stride}] one paired batch on the card: "
            f"{fast_ms:.6f} ms (the unit count's readback included), "
            f"{B / fast_ms * 1e3:.0f} pairs/s; dense {step_ms:.6f} ms")
    fcfg = dataclasses.replace(cfg, probe_sample=16)
    readback_gap(lambda: map_step(
        di, fcfg, tables[0], mates[0][0], mates[0][2], weights,
        codes2=mates[1][0], lengths2=mates[1][2], bad=mates[0][1],
        bad2=mates[1][1], pad_len=L, audit=True))
    fast_tables = [make_sig_table(22, C, num_ecs=index.num_ecs, device=dev)
                   for _ in range(2)]
    map_step(di, fcfg, fast_tables[0], mates[0][0], mates[0][2], weights,
             codes2=mates[1][0], lengths2=mates[1][2], bad=mates[0][1],
             bad2=mates[1][1], pad_len=L, audit=True)
    fsig, fmapped = probe.two_phase_signatures(
        mates, L, k, 16, C, di.table, di.main_slots, di.stash,
        di.stash_slots, di.bucket)
    accumulate_cuda.plain(fast_tables[1], fsig, fmapped, weights=weights,
                          audit=True)
    fk, fp = (merge_sig_rows(*table_to_host(t), B, int(t.overflow),
                             int(t.collisions)) for t in fast_tables)
    check(np.array_equal(fk.sigs, fp.sigs)
          and np.array_equal(fk.sig_counts, fp.sig_counts)
          and (fk.mapped, fk.overflow, fk.collisions)
          == (fp.mapped, fp.overflow, fp.collisions),
          "the fast map step on the card differs from the plain route")
    log(f"[map step fast s=16] its table equals the plain route's on the "
        f"same card tensors: {fk.sigs.shape[0]} signatures, mapped "
        f"{fk.mapped}, overflow {fk.overflow}, collisions {fk.collisions}")
    del di
    torch.cuda.empty_cache()
    return out, steps


def group_masses(alpha, M):
    """Mass of each group of transcripts with identical EC membership,
    [R, G]: such transcripts are EM-degenerate (any split among them is a
    fixed point), so only the group's sum is determined."""
    import torch

    g = torch.unique(M.t(), dim=0, return_inverse=True)[1]
    return torch.zeros((alpha.shape[0], int(g.max()) + 1), device=alpha.device,
                       dtype=alpha.dtype).index_add_(1, g, alpha)


def check_em_kernel(tag, M, n, inv_eff, alpha0, cfg, control: bool):
    """K4 against its plain version on one system: converged iteration
    counts within one check_every block and group masses within 1e-3
    relative + 1e-2 reads; at a fixed iteration count (the converged
    run's) group masses within 1e-2 reads and equal bits from two runs;
    with ``control``, the plain version with TF32 products must miss that
    bound. Returns (iterations, converged group-mass error)."""
    import torch

    from seekmer_tpu_torch.ops import em_cuda, em_dense

    R, T = alpha0.shape
    (got, it), (want, it_p) = (em_cuda.em_fixed_point(M, n, inv_eff, alpha0,
                                                      cfg),
                               em_dense.em_fixed_point(M, n, inv_eff, alpha0,
                                                       cfg))
    torch.cuda.synchronize()
    check(abs(it - it_p) <= cfg.check_every,
          f"K4 {tag}: {it} iterations, plain {it_p}")
    gk, gp = group_masses(got, M), group_masses(want, M)
    err = float((gk - gp).abs().max())
    bad = float(((gk - gp).abs() - 1e-3 * gp.abs()).max())
    check(bool(torch.isfinite(got).all()) and bad <= 1e-2,
          f"K4 {tag} group masses disagree: max abs {err}")
    # the same fixed count on both sides (rel_tol 0 never converges): they
    # differ by float32 rounding alone, so the group masses agree within
    # 1e-2 reads. The control, the plain version with TF32 products, shows
    # what that bound makes of lower precision.
    fixed = dataclasses.replace(cfg, rel_tol=0.0, min_iters=it, max_iters=it)
    (fk, itk), (fk2, _), (fp, itp) = (
        em_cuda.em_fixed_point(M, n, inv_eff, alpha0, fixed),
        em_cuda.em_fixed_point(M, n, inv_eff, alpha0, fixed),
        em_dense.em_fixed_point(M, n, inv_eff, alpha0, fixed))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ft = em_dense.em_fixed_point(M, n, inv_eff, alpha0, fixed)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    gf = group_masses(fp, M)
    tight = float((group_masses(fk, M) - gf).abs().max())
    tf32 = float((group_masses(ft, M) - gf).abs().max())
    check(itk == itp == it and tight <= 1e-2,
          f"K4 {tag}, fixed {it} iterations: group masses disagree by "
          f"{tight} reads (kernel {itk}, plain {itp} iterations)")
    check(torch.equal(fk, fk2), f"K4 {tag}: two runs differ in their bits")
    if control:
        check(tf32 > 1e-2, f"K4 {tag}: the TF32 control reads {tf32}, "
              "inside the bound that should reject it")
    log(f"[K4 {tag}] plan {em_cuda.plan(M.shape[0], T, R, M.device)}; "
        f"iterations {it} (plain {it_p}); {gk.shape[1]} membership groups, "
        f"max abs group-mass error {err:.6g} reads (bound 1e-3 relative + "
        f"1e-2); fixed {it} iterations: {tight:.6g} reads (bound 1e-2), "
        f"equal bits on a rerun, TF32 control {tf32:.6g} reads")
    return it, err


def time_em_kernel(tag, M, n, inv_eff, alpha0, cfg, it):
    """Kernel and plain time of the converged run (``it`` iterations) beside
    its bound: the larger of the bytes it must move (M, n, inv_eff and
    alpha0 read once, alpha written once) and the FP32 operations its
    iterations need on M's nonzeros (each of the two products 2 nnz R, the
    elementwise steps R (E + 2 T)). The library time is the two FP32
    torch.matmul products of an iteration, run ``it`` times (context only:
    the port never calls them, and they skip the elementwise steps)."""
    from seekmer_tpu_torch.ops import em_cuda, em_dense

    R, T = alpha0.shape
    E = M.shape[0]
    ms = cuda_ms(lambda: em_cuda.em_fixed_point(M, n, inv_eff, alpha0, cfg),
                 5)
    plain_ms = cuda_ms(lambda: em_dense.em_fixed_point(M, n, inv_eff, alpha0,
                                                       cfg), 3)
    x = alpha0 * inv_eff
    r = n.clone()
    Mt = M.t()

    def products():
        for _ in range(it):
            x @ Mt, r @ M

    mm_ms = cuda_ms(products, 3)
    nnz = int((M != 0).sum())
    ops_s = it * (4.0 * nnz * R + R * (E + 2.0 * T)) / FP32_FLOPS
    bytes_s = (nbytes(M, n, inv_eff, alpha0) + 4 * R * T) / HBM_BYTES_S
    bound_s = max(ops_s, bytes_s)
    dense_tf32_us = 2 * 4.0 * R * E * T / TF32_FLOPS * 1e6
    log(f"[K4 {tag}] kernel {ms:.6f} ms ({ms / it * 1e3:.3f} us/it), plain "
        f"{plain_ms:.6f} ms ({plain_ms / it * 1e3:.3f} us/it); bound "
        f"{bound_s * 1e3:.6f} ms (nnz {nnz}: operations "
        f"{ops_s * 1e3:.6f} ms, bytes {bytes_s * 1e3:.6f} ms; share "
        f"{bound_s * 1e3 / ms:.6f}); the dense split TF32 products alone "
        f"{dense_tf32_us:.3f} us/it at the TF32 peak; two FP32 torch.matmul "
        f"x {it} iterations {mm_ms:.6f} ms")
    return record(None, ms, plain_ms, bound_s,
                  "operations" if ops_s >= bytes_s else "bytes", mm_ms)


def compare_em_kernel(work: Path):
    """K4 against its plain version at the config-1 bootstrap shapes (the
    world's ECs from the port's mapper, 100 replicates from the port's
    resampler with a fixed generator) and at R = 1, under the EM settings
    of the config-1 infer run; then on two systems at the dense gate's
    edge that walk their depth in chunks. Returns the R = 100 record."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig, MapConfig
    from seekmer_tpu_torch.em.bootstrap import resample_counts
    from seekmer_tpu_torch.em.em import (build_ec_table, dense_membership,
                                         effective_lengths)
    from seekmer_tpu_torch.io.fastq import batch_reads_native
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.ops import em_cuda, em_dense
    from seekmer_tpu_torch.utils.prefetch import device_put_batches

    dev = torch.device(DEVICE)
    index = load_index(work, "c1")
    cfg_map = MapConfig(batch_size=B)
    result = Mapper(index, cfg_map, device=dev).run(device_put_batches(
        batch_reads_native([str(work / "c1.fq")], cfg_map), dev))
    members, counts, _ = resolve_signatures(result, index)
    T = index.num_transcripts
    ec = build_ec_table(members, counts, T, device=dev)
    M = dense_membership(ec)
    cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    inv_eff = 1.0 / effective_lengths(index.lengths, cfg, torch.float32, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cmat = resample_counts(ec.counts, 100, gen)
    out = None
    for n in (cmat, ec.counts[None, :]):
        R = n.shape[0]
        alpha0 = (n.sum(dim=1, keepdim=True) / T).expand(R, T).contiguous()
        tag = f"config-1 E {ec.num_ecs} T {T} R {R}"
        it, err = check_em_kernel(tag, M, n, inv_eff, alpha0, cfg,
                                  control=R > 1)
        rec = time_em_kernel(tag, M, n, inv_eff, alpha0, cfg, it)
        if out is None:
            out = dict(rec, max_abs_err=err)
        time_csr_beside_k4(tag, ec, n, inv_eff, alpha0, it, rec["ms"])

    # at the gate's edge, both ways: E-deep, E x T pads to 7,680 x 256 =
    # 1.97M of the gate's 2M entries; T-deep, 128 x 14,464 = 1.85M, the
    # widest T the gate admits at R = 8. Neither system's depth fits in
    # shared memory, so each phase gathers it in chunks. Every transcript
    # is in some EC. The TF32 control is asked of the E-deep system only.
    cfg2 = EMConfig(rel_tol=1e-6, max_iters=400)
    rng = np.random.default_rng(SEED)
    for E2, T2, R2 in ((7600, 250, 8), (100, 14400, 8)):
        check(em_dense.fits_dense(E2, T2, R2),
              f"near-gate system E {E2} T {T2} R {R2} over the gate")
        plan = em_cuda.plan(E2, T2, R2, dev)
        check(0 < plan["KC"] < plan["cluster"] * max(plan["SE"], plan["ST"]),
              f"near-gate system does not take the chunked path: {plan}")
        M2 = np.zeros((E2, T2), np.float32)
        for e in range(E2):
            M2[e, rng.choice(T2, size=int(rng.integers(1, 6)),
                             replace=False)] = 1
        M2[rng.integers(0, E2, size=T2), np.arange(T2)] = 1
        n2 = rng.integers(0, 50, size=(R2, E2)).astype(np.float32)
        inv2 = (1.0 / rng.integers(50, 3000, size=T2)).astype(np.float32)
        a2 = np.repeat(n2.sum(axis=1, keepdims=True) / T2, T2, axis=1)
        sys2 = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
                for a in (M2, n2, inv2, a2)]
        tag = f"near gate E {E2} T {T2} R {R2}"
        it, _ = check_em_kernel(tag, *sys2, cfg2, control=E2 > T2)
        time_em_kernel(tag, *sys2, cfg2, it)
    return out


def time_csr_beside_k4(tag, ec, n, inv_eff, alpha0, it, k4_ms):
    """A3 on K4's system (the batched form, counts n [R, E], alpha0
    [R, T]): one launch of ``it`` steps against the plain version on the
    CPU (equal bits), then the fixed point over ``it`` iterations (one
    launch, the test every 16) timed beside K4's converged run of ``it``
    iterations and A3's bound (``csr_bound``), for the dense route's
    gate."""
    import torch

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em.em import csr_layout
    from seekmer_tpu_torch.ops import em_csr_cuda
    from seekmer_tpu_torch.utils import kernel_ab

    E, T = ec.num_ecs, ec.num_transcripts
    lay = csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    args = (alpha0.t().contiguous(), n.t().contiguous(),
            inv_eff.reshape(-1).contiguous())
    got = em_csr_cuda.em_steps(*args, lay, it, False)
    want = em_csr_cuda.plain_steps(
        *(a.cpu() for a in args),
        csr_layout(ec.ec_ids.cpu(), ec.txp_ids.cpu(), E, T), it, False)
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          f"A3 at {tag}: {it} steps differ from the plain version on the CPU")
    cfg = EMConfig(rel_tol=0.0, min_iters=it, max_iters=it)
    ms = kernel_ab.device_ms(lambda: em_csr_cuda.em_fixed_point(
        *args, lay, cfg, False), 10)
    B = args[0].shape[1]
    bb, bo = csr_bound(em_csr_cuda.tiling(lay, B, torch.float32), E, T,
                       ec.ec_ids.numel(), B, it, 4)
    log(f"[A3 beside K4, {tag}] {it} steps in one launch: equal bits to the "
        f"plain version on the CPU; the fixed point over {it} iterations "
        f"{ms:.6f} ms ({ms / it * 1e3:.3f} us/it) device time, bound "
        f"{max(bb, bo) * 1e3:.6f} ms (share {max(bb, bo) * 1e3 / ms:.6f}); "
        f"K4's converged run {k4_ms:.6f} ms ({k4_ms / it * 1e3:.3f} us/it)")


def group_masses_np(ec, alphas):
    """Mass of each group of transcripts with identical EC membership in
    each (T, B) iterate of ``alphas`` (numpy float64, [B, G] each): the
    group of a transcript is a random 64-bit key per EC summed over its
    ECs (wrapping), so equal membership gives equal keys."""
    import numpy as np

    ec_ids, txp = ec.ec_ids.cpu().numpy(), ec.txp_ids.cpu().numpy()
    key = np.zeros(ec.num_transcripts, np.uint64)
    np.add.at(key, txp, np.random.default_rng(SEED).integers(
        0, 2**64, size=ec.num_ecs, dtype=np.uint64)[ec_ids])
    g = np.unique(key, return_inverse=True)[1]
    return [np.stack([np.bincount(g, weights=col) for col in
                      a.cpu().numpy().astype(np.float64).T])
            for a in alphas]


def csr_bound(tl, E, T, nnz, B, its, elem, C=16):
    """(bytes s, operations s) of an A3 launch of ``its`` iterations, the
    test every ``C``: alpha0 and the counts (E, B), the scale and the tiled
    layout read once, alpha written once; an iteration does 4 operations a
    membership entry and replicate (the E-phase's sum, the M-phase's
    product, quotient and sum) and one a transcript and replicate (its
    weight, stored once), and each block's test 5 a transcript and
    replicate; at the FP32 or FP64 peak."""
    moved = elem * (2 * T * B + E * B + T) + tl.index_bytes()
    ops = its * (4.0 * nnz + T) * B + -(-its // C) * 5.0 * T * B
    return moved / HBM_BYTES_S, ops / (FP64_FLOPS if elem == 8 else FP32_FLOPS)


def compare_csr_em(ec, lengths):
    """A3 at config 2's EC table (the batched CSR bootstrap route), with
    100 replicates resampled on the card from a fixed generator:

    - the tiling: components (the largest in transcripts and ECs), tiles,
      slice width, resident or streamed, shared memory a block, the grid,
      its build time, at B 100 and B 1;
    - the whole fixed point (``em_fixed_point``, one launch) against the
      plain blocked loop on CPU tensors, at B 100 and B 1, float32 and
      float64, with a rel_tol at which the test stops it before
      ``max_iters``: equal iteration count, converged flag and bits;
    - one launch of 16 steps (``em_steps``, SQUAREM's launch) against the
      plain version on CPU tensors: equal bits, and a rerun: equal bits;
    - 480 steps against the plain version on the card (torch gathers and
      ``index_add_``, whose atomics add in another order): the mass of
      each group of transcripts with identical EC membership within 1e-3
      relative + 1e-2 reads;
    - the entry points on the card against the same calls on the CPU, a
      fixed 480 iterations: ``batched_em`` on the first 4 replicates and
      ``run_em`` in float32 and float64, equal bits, one launch each;
    - device time (card kept busy) of the fixed point over 480 iterations
      at 100 replicates and at 1 (the single run), float64 beside its
      bound at the FP64 peak, float32 beside the earlier form's
      155.248 and 11.923 us an iteration (one launch a 16-step block, the
      test on the host; NVIDIA H100 80GB HBM3, 700 W), the plain blocked
      loop on the card, the
      bound (``csr_bound``) and the library form over the same 480
      iterations: two cuSPARSE products (``torch.sparse.mm`` on CSR) and
      the elementwise work between, an iteration.

    Returns A3's record (the fixed point at 100 replicates)."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em.bootstrap import batched_em, resample_counts
    from seekmer_tpu_torch.em.em import csr_layout, effective_lengths, run_em
    from seekmer_tpu_torch.ops import em_csr_cuda
    from seekmer_tpu_torch.utils import kernel_ab

    dev = ec.counts.device
    E, T, nnz = ec.num_ecs, ec.num_transcripts, ec.ec_ids.numel()
    R, C = 100, EMConfig().check_every
    eff = effective_lengths(lengths, EMConfig(), torch.float32, dev)
    inv = 1.0 / eff
    lay = csr_layout(ec.ec_ids, ec.txp_ids, E, T)
    lay_cpu = csr_layout(ec.ec_ids.cpu(), ec.txp_ids.cpu(), E, T)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cmat = resample_counts(ec.counts, R, gen)
    counts = cmat.t().contiguous()
    alpha0 = (cmat.sum(dim=1)[None, :] / T).expand(T, R).contiguous()
    batched = (alpha0, counts, inv)
    one = ((ec.counts.sum() / T).repeat(T), ec.counts, eff)

    for B, dt in ((R, torch.float32), (1, torch.float32), (R, torch.float64)):
        blocks, cap = em_csr_cuda.grid_shape(dev.index, dt == torch.float64)
        elem = 8 if dt == torch.float64 else 4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tl = em_csr_cuda.tiled_layout(lay, B, elem, cap, blocks)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        sizes = np.diff(tl.tile_t0.cpu().numpy())[:tl.ntiles]
        log(f"[A3 tiling config 2 B {B} {dt}] {tl.components} components, "
            f"the largest {tl.largest[0]} transcripts x {tl.largest[1]} ECs; "
            f"{tl.ntiles} tiles of {int(sizes.min()) if tl.ntiles else 0}-"
            f"{int(sizes.max()) if tl.ntiles else 0} transcripts, "
            f"{tl.slices} slice(s) of {tl.width}, "
            f"{'resident' if tl.resident else 'streamed'}, "
            f"{tl.ntiles * tl.slices} items on a grid of {blocks} blocks, "
            f"{tl.smem} of {cap} bytes of shared memory a block; global "
            f"route {tl.global_rows[0]} transcripts x {tl.global_rows[1]} "
            f"ECs; built in {build_ms:.3f} ms (torch ops on the card)")

    # the whole fixed point against the plain blocked loop on the CPU, at
    # the least rel_tol of these at which the test stops it before
    # max_iters (12 blocks)
    for B, dt in ((R, torch.float32), (R, torch.float64),
                  (1, torch.float32), (1, torch.float64)):
        args = tuple(a.to(dt) for a in (batched if B == R else one))
        divide = B == 1
        for tol in (1e-2, 3e-2, 1e-1, 3e-1, 1.0):
            cfg = EMConfig(rel_tol=tol, max_iters=192)
            got = em_csr_cuda.em_fixed_point(*args, lay, cfg, divide)
            if got[2] and got[1] < cfg.max_iters:
                break
        check(got[2] and got[1] < cfg.max_iters,
              f"A3 fixed point, B {B} {dt}: no tolerance stopped it before "
              f"{cfg.max_iters} iterations")
        t0 = time.perf_counter()
        want = em_csr_cuda.em_fixed_point(*(a.cpu() for a in args), lay_cpu,
                                          cfg, divide)
        cpu_s = time.perf_counter() - t0
        check(got[1:] == want[1:] and torch.equal(got[0].cpu(), want[0]),
              f"A3 fixed point, B {B} {dt}, rel_tol {tol}: card ({got[1]}, "
              f"{got[2]}) and CPU ({want[1]}, {want[2]}) differ, max abs "
              f"{float((got[0].cpu() - want[0]).abs().max())}")
        log(f"[A3 fixed point config 2 B {B} {dt}] rel_tol {tol}: converged "
            f"after {got[1]} of at most {cfg.max_iters} iterations on the "
            f"card and on the CPU, equal bits ({cpu_s:.1f} s on the CPU)")

    got = em_csr_cuda.em_steps(*batched, lay, C, False)
    again = em_csr_cuda.em_steps(*batched, lay, C, False)
    t0 = time.perf_counter()
    want = em_csr_cuda.plain_steps(*(a.cpu() for a in batched), lay_cpu, C,
                                   False)
    cpu_s = time.perf_counter() - t0
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          f"A3, {R} replicates, {C} steps: not the CPU's bits (max abs "
          f"{err})")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "A3: a rerun gives other bits")

    fixed = 480
    kern = em_csr_cuda.em_steps(*batched, lay, fixed, False)[1]
    plain = em_csr_cuda.plain_steps(*batched, lay, fixed, False)[1]
    gk, gp = group_masses_np(ec, (kern, plain))
    gerr = float(np.abs(gk - gp).max())
    bad = float((np.abs(gk - gp) - 1e-3 * np.abs(gp)).max())
    apart = float(np.abs(gp[1:] - gp[:-1]).max())
    check(bool(np.isfinite(gk).all()) and bad <= 1e-2 and apart > 1.0,
          f"A3, {fixed} steps: group masses differ from the plain version "
          f"on the card by {gerr} reads (replicates apart by {apart})")

    cfg = EMConfig(rel_tol=0.0, min_iters=fixed, max_iters=fixed)
    on_cpu = ec._replace(counts=ec.counts.cpu(), ec_ids=ec.ec_ids.cpu(),
                         txp_ids=ec.txp_ids.cpu())
    entry = []
    for name, fn in (
            ("batched_em, 4 replicates", lambda t, c: batched_em(
                cmat[:4].to(t.counts.device), t.ec_ids, t.txp_ids, lengths,
                E, T, c)),
            ("run_em float32", lambda t, c: run_em(t, lengths, c)),
            ("run_em float64", lambda t, c: run_em(
                t._replace(counts=t.counts.double()), lengths,
                dataclasses.replace(c, use_x64=True)))):
        before = em_csr_cuda.em_steps.launches
        a, ia = fn(ec, cfg)
        launched = em_csr_cuda.em_steps.launches - before
        b, ib = fn(on_cpu, cfg)
        check(ia == ib == fixed and launched == 1
              and torch.equal(a.cpu(), b),
              f"A3 through {name}: card and CPU differ ({ia} / {ib} "
              f"iterations, {launched} launches)")
        entry.append(name)

    # device times of the whole fixed point, 480 iterations, the test every
    # 16; the plain blocked loop and the library form over the same count
    timed = EMConfig(rel_tol=0.0, min_iters=fixed, max_iters=fixed)
    ms = kernel_ab.device_ms(lambda: em_csr_cuda.em_fixed_point(
        *batched, lay, timed, False), 5)
    ms1 = kernel_ab.device_ms(lambda: em_csr_cuda.em_fixed_point(
        *one, lay, timed, True), 10)
    ms16 = kernel_ab.device_ms(
        lambda: em_csr_cuda.em_steps(*batched, lay, C, False), 20)
    plain_ms = cuda_ms(lambda: em_csr_cuda.plain_fixed_point(
        *batched, lay, timed, False), 2)
    plain1_ms = cuda_ms(lambda: em_csr_cuda.plain_fixed_point(
        *one, lay, timed, True), 2)

    ones = torch.ones(nnz, dtype=torch.float32, device=dev)
    A = torch.sparse_csr_tensor(lay.ec_off, lay.txp, ones, (E, T))
    At = torch.sparse_csr_tensor(lay.txp_off, lay.csc_ec, ones, (T, E))
    inv_col = inv[:, None]

    def library(steps):
        a = alpha0
        for _ in range(steps):
            w = a * inv_col
            d = torch.sparse.mm(A, w)
            a = w * torch.sparse.mm(At, torch.where(d > 0, counts / d, 0.0))
        return a

    gl, gk = group_masses_np(ec, (library(C), got[1]))
    lerr = float(np.abs(gl - gk).max())
    check(float((np.abs(gl - gk) - 1e-3 * np.abs(gk)).max()) <= 1e-2,
          f"the library form differs from A3 by {lerr} reads")
    library_ms = cuda_ms(lambda: library(fixed), 2)

    b_bytes, b_ops = csr_bound(em_csr_cuda.tiling(lay, R, torch.float32), E,
                               T, nnz, R, fixed, 4)
    b1_bytes, b1_ops = csr_bound(em_csr_cuda.tiling(lay, 1, torch.float32),
                                 E, T, nnz, 1, fixed, 4)
    log(f"[A3 em_csr config 2] E {E}, T {T}, nnz {nnz}, {R} replicates: "
        f"{C} steps equal bits to the plain version on the CPU "
        f"({cpu_s:.3f} s there) and on a rerun; {fixed} steps against the "
        f"plain version on the card: max abs group-mass error {gerr:.6g} "
        f"reads (bound 1e-3 relative + 1e-2), replicates apart by up to "
        f"{apart:.6g}; card against CPU over {fixed} iterations, equal bits, "
        f"one launch each: {', '.join(entry)}; library form against A3 "
        f"after {C} steps: {lerr:.6g} reads")
    for tag, k, p, bb, bo, before in (
            (f"B {R}", ms, plain_ms, b_bytes, b_ops, 155.248),
            ("B 1 (single run)", ms1, plain1_ms, b1_bytes, b1_ops, 11.923)):
        bnd = max(bb, bo) * 1e3
        log(f"[A3 em_csr config 2 {tag}] the fixed point, one launch of "
            f"{fixed} iterations (the test every {C}): {k:.6f} ms device "
            f"time ({k / fixed * 1e3:.3f} us/it; one launch a 16-step block: "
            f"{before} us/it), plain blocked loop on the card {p:.6f} ms "
            f"({p / fixed * 1e3:.3f} "
            f"us/it); bound {bnd:.6f} ms (bytes {bb * 1e3:.6f} ms, "
            f"operations {bo * 1e3:.6f} ms; share {bnd / k:.6f})")
    # float64 (``use_x64``): the same fixed point, its bound at the FP64 peak
    for B, args, divide, reps in ((R, batched, False, 3), (1, one, True, 10)):
        a64 = tuple(a.double() for a in args)
        k = kernel_ab.device_ms(lambda: em_csr_cuda.em_fixed_point(
            *a64, lay, timed, divide), reps)
        bb, bo = csr_bound(em_csr_cuda.tiling(lay, B, torch.float64), E, T,
                           nnz, B, fixed, 8)
        bnd = max(bb, bo) * 1e3
        log(f"[A3 em_csr config 2 B {B} float64] the fixed point, one launch "
            f"of {fixed} iterations: {k:.6f} ms device time "
            f"({k / fixed * 1e3:.3f} us/it); bound {bnd:.6f} ms (bytes "
            f"{bb * 1e3:.6f} ms, operations {bo * 1e3:.6f} ms at "
            f"{FP64_FLOPS / 1e12:.0f} TFLOP/s; share {bnd / k:.6f})")
    log(f"[A3 em_csr config 2 B {R}] one em_steps launch of {C} steps "
        f"(SQUAREM's form, test off) {ms16:.6f} ms ({ms16 / C * 1e3:.3f} "
        f"us/it; the earlier form: 2.483974 ms); library form (two cuSPARSE "
        f"SpMM and the elementwise work, {fixed} iterations) "
        f"{library_ms:.6f} ms "
        f"({library_ms / fixed * 1e3:.3f} us/it)")
    return record(err, ms, plain_ms, max(b_bytes, b_ops),
                  "bytes" if b_bytes >= b_ops else "operations", library_ms)


def check_ec_sum(ec, lengths, keep=None):
    """A4 (``em_csr_cuda.ec_sums``, ``log_likelihood``'s per-EC sums) at
    config 2's EC table on the terms ``log_likelihood`` sums (theta / eff
    of each member, alpha from a seeded generator): bit for bit against
    its plain version on the card and on the CPU; device time (card kept
    busy; the whole call, one launch) beside the plain version (one
    elementwise add a rank, as many ranks as the largest EC has members),
    two library calls (``index_add_``, atomics in no fixed order, and
    ``segment_reduce`` on offsets built once outside the timed call,
    whose bits are compared with A4's), an empty launch of A4's grid and
    the bytes bound (w and ec_ids read, the sums written); and the host
    wall of a call with the read back ``log_likelihood`` does, for A4, the
    plain version and ``index_add_``. ``keep``: write (w, ec_ids, E) there
    for ``utils/kernel_ab.py``. Returns A4's record; its library time is
    ``segment_reduce``'s where its bits are A4's, else ``index_add_``'s."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em.em import effective_lengths, ordered_sum
    from seekmer_tpu_torch.ops import accumulate_cuda, em_csr_cuda
    from seekmer_tpu_torch.utils import kernel_ab

    dev = ec.counts.device
    E, nnz = ec.num_ecs, ec.ec_ids.numel()
    alpha = torch.from_numpy(np.random.default_rng(SEED).random(
        ec.num_transcripts)).to(ec.counts.dtype).to(dev)
    eff = effective_lengths(lengths, EMConfig(), alpha.dtype, dev)
    theta = alpha / ordered_sum(alpha)
    w = theta[ec.txp_ids] / eff[ec.txp_ids]
    ids = ec.ec_ids
    if keep:
        torch.save({"w": w.cpu(), "ec_ids": ids.cpu(), "E": E}, keep)
    before = em_csr_cuda.ec_sums.launches
    got = em_csr_cuda.ec_sums(w, ids, E)
    check(em_csr_cuda.ec_sums.launches == before + 1,
          "A4 ec_sum config 2: not one launch a call")
    plain = em_csr_cuda.plain_ec_sums(w, ids, E)
    cpu = em_csr_cuda.plain_ec_sums(w.cpu(), ids.cpu(), E)
    err = float((got - plain).abs().max())
    check(torch.equal(got, plain) and torch.equal(got.cpu(), cpu),
          f"A4 ec_sum config 2: differs from its plain version (max abs "
          f"err {err})")

    def library():
        return torch.zeros(E, dtype=w.dtype, device=dev).index_add_(0, ids, w)

    offsets = torch.searchsorted(ids, torch.arange(E + 1, device=dev))

    def segment():
        return torch.segment_reduce(w, "sum", offsets=offsets)

    seg_same = torch.equal(segment(), got)
    largest = int(torch.bincount(ids, minlength=E).max())
    ms = kernel_ab.device_ms(lambda: em_csr_cuda.ec_sums(w, ids, E), 50)
    plain_ms = cuda_ms(lambda: em_csr_cuda.plain_ec_sums(w, ids, E), 3)
    library_ms = kernel_ab.device_ms(library, 50)
    segment_ms = kernel_ab.device_ms(segment, 50)
    floor_ms = kernel_ab.device_ms(
        lambda: accumulate_cuda.empty_launch(nnz, dev, False), 50)

    def host_ms(fn, reps=10):
        fn().cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn().cpu()
        return (time.perf_counter() - t0) * 1e3 / reps

    walls = [host_ms(f) for f in (
        lambda: em_csr_cuda.ec_sums(w, ids, E),
        lambda: em_csr_cuda.plain_ec_sums(w, ids, E), library)]
    bound_s = nbytes(w, ids, got) / HBM_BYTES_S
    log(f"[A4 ec_sum config 2] {E} ECs, nnz {nnz}, the largest EC "
        f"{largest} members; max_abs_err {err} (the plain version on the "
        f"card and on the CPU: equal bits), kernel {ms:.6f} ms (device "
        f"time, the whole call: one launch), plain {plain_ms:.6f} ms, "
        f"index_add_ {library_ms:.6f} ms, segment_reduce {segment_ms:.6f} "
        f"ms (offsets built outside; its bits "
        f"{'equal to' if seg_same else 'differ from'} A4's), an empty "
        f"launch of A4's grid {floor_ms:.6f} ms, bound "
        f"{bound_s * 1e3:.6f} ms (share {bound_s * 1e3 / ms:.6f}; below "
        f"the launch floor); host wall a call with the read back: A4 "
        f"{walls[0]:.6f} ms, plain {walls[1]:.6f} ms, index_add_ "
        f"{walls[2]:.6f} ms")
    return record(err, ms, plain_ms, bound_s, "bytes",
                  segment_ms if seg_same else library_ms)


def reset_launches():
    from seekmer_tpu_torch.ops import (accumulate_cuda, em_csr_cuda,
                                       em_cuda, fast_cuda, pack_cuda,
                                       probe_cuda, route_cuda, sig_cuda,
                                       strided_cuda)

    for fn in (pack_cuda.pack_canonical_2bit, probe_cuda.lookup_ecs_aux,
               sig_cuda.read_signatures, accumulate_cuda.fold_batch,
               em_cuda.em_fixed_point, fast_cuda.sample_classify,
               fast_cuda.merge_staging, em_csr_cuda.em_steps,
               strided_cuda.lookup_ecs_strided, em_csr_cuda.ec_sums,
               route_cuda.route_first, route_cuda.route_spill,
               route_cuda.unroute):
        fn.launches = 0


FAST = ("sample", "merge")  # fast mode's kernels
STRIDED = ("strided",)  # strided mode's
ROUTED = ("route", "unroute")  # the prefix-sharded index's


def run_infer(work: Path, tag: str, argv, unused=(), name=None):
    """Run the CLI's infer on world ``tag`` into ``<name>_out``; every
    kernel but those in ``unused`` and R1 and R2 must have launched during
    it, and those must not have."""
    from seekmer_tpu_torch import cli

    name = name or tag
    unused = (*unused, *ROUTED)  # one card routes nothing
    out = work / f"{name}_out"
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["infer", str(work / f"{tag}.npz"), str(out), *argv,
                   "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = cli.kernel_launches()
    check(rc == 0, f"{tag} infer exit {rc}")
    info = json.loads((out / "run_info.json").read_text())
    t = info["timings"]
    log(f"[{name} e2e] mapped {info['mapped']} / {info['total_reads']}, "
        f"EM iterations {info['em_iterations']}, map stage "
        f"{t['reads_per_s']:.0f} reads/s ({t['map_s']:.3f} s), EM "
        f"{t['em_iterations_per_s']:.1f} it/s ({t['em_s']:.3f} s), resolve "
        f"{t['resolve_s']:.3f} s, quantifier {t['wall_s']:.3f} s, CLI wall "
        f"{wall:.1f} s, kernel launches {launches}")
    for kernel, n in launches.items():
        if kernel in unused:
            check(n == 0, f"{name}: kernel {kernel} launched {n} times")
        else:
            check(n > 0, f"{name}: kernel {kernel} was never launched")
    return out, info, launches


def check_bootstrap(tag: str, out: Path, info, T: int):
    """bootstrap.npz holds [100, T] replicates, each carrying the mapped
    reads. The route is read from K4's launch count (``run_infer`` checked
    it against the expected one); A3 launches once for the single run and,
    on the batched CSR route, once for the bootstrap."""
    import numpy as np

    boot = np.load(out / "bootstrap.npz")["est_counts"]
    check(boot.shape == (100, T), f"{tag} bootstrap shape {boot.shape}")
    check(bool(np.isfinite(boot).all()), f"{tag} bootstrap non-finite")
    mass = boot.sum(axis=1)
    err = float(np.abs(mass - info["mapped"]).max() / info["mapped"])
    check(err < 1e-3, f"{tag} bootstrap row mass off by {err:.3g}")
    t = info["timings"]
    k4 = info["kernel_launches"]["em"]
    log(f"[{tag} bootstrap] {boot.shape[0]} x {boot.shape[1]}, route "
        f"{'dense (K4)' if k4 else 'batched CSR (A3)'} (K4 launches {k4}, "
        f"A3 launches {info['kernel_launches']['em_csr']}), "
        f"{int(t['bootstrap_iterations'])} "
        f"iterations, stage wall {t['bootstrap_s']:.6f} s; row mass vs "
        f"mapped {info['mapped']}: max relative error {err:.3g}")


def end_to_end(work: Path):
    """The ``infer`` runs of phase 4. Returns the sum of their launches,
    the run_info of the dense and fast runs ({"c1" | "c2" | "c1 fast" |
    "c2 fast": run_info}) and config 1's raw MapResult from the plain path
    on the CPU."""
    import numpy as np

    from seekmer_tpu_torch import EMConfig, MapConfig
    from seekmer_tpu_torch.io.writer import read_abundance

    out, info, l1 = run_infer(work, "c1", [
        str(work / "c1.fq"), "--em-tolerance", "1e-6", "--em-max-iters",
        "2000", "--bootstrap", "100", "--seed", "1"],
        unused=(*FAST, *STRIDED))
    index = load_index(work, "c1")
    check_bootstrap("c1", out, info, index.num_transcripts)
    em_cfg = EMConfig(rel_tol=1e-6, max_iters=2000)
    t0 = time.perf_counter()
    ref = cpu_reference(work, index, em_cfg)
    tab = read_abundance(str(out / "abundance.tsv"))
    check(info["unmapped"] == ref["unmapped"]
          and info["mapped"] == ref["mapped"],
          f"config-1 mapped {info['mapped']} / unmapped {info['unmapped']} "
          f"!= CPU reference {ref['mapped']} / {ref['unmapped']}")
    tpm_err_tsv = float(np.abs(tab["tpm"] - ref["tpm"]).max())
    # bench.py's metric: the port's float32 EM on the card against float64
    # EM, on the same equivalence classes
    tpm_err = em_tpm_error(index, ref, em_cfg)
    top = float(ref["tpm"].max())
    log(f"[c1 reference] mapped {info['mapped']}, unmapped "
        f"{info['unmapped']} == the plain path on the CPU; TPM max-abs "
        f"error, f32 EM on the card vs f64 EM on the CPU: {tpm_err:.6g}; "
        f"abundance.tsv (6 significant digits) vs f64: {tpm_err_tsv:.6g}; "
        f"largest TPM {top:.6g} ({time.perf_counter() - t0:.1f} s)")
    # float32 EM to rel_tol 1e-6 stays orders of magnitude inside 1e-5 of
    # the largest TPM; the table's 6 significant digits add up to 5e-6
    check(tpm_err < 1e-5 * top and tpm_err_tsv < 2e-5 * top,
          "config-1 TPM error against float64 EM")

    # no fragment flags: the fragment-length distribution is estimated
    out2, info2, l2 = run_infer(work, "c2", [
        str(work / "c2_1.fq"), "--mates", str(work / "c2_2.fq"),
        "--sig-table-bits", "22", "--bootstrap", "100"],
        unused=("em", *FAST, *STRIDED))
    fld = info2["fld"]
    check(fld is not None, "config-2 FLD was not estimated")
    log(f"[c2 fld] mean {fld['mean']:.6f} (simulated 200), sd "
        f"{fld['sd']:.6f} (simulated 20), {fld['samples']} samples")
    check(abs(fld["mean"] - 200.0) < 10.0 and abs(fld["sd"] - 20.0) < 10.0
          and fld["samples"] > 1000, f"config-2 FLD estimate {fld}")
    tab2 = read_abundance(str(out2 / "abundance.tsv"))
    check_bootstrap("c2", out2, info2, tab2["target_id"].size)
    check(info2["total_reads"] == BATCHES * B, "config-2 read count")
    check(info2["mapped"] > 0.8 * BATCHES * B,
          f"config-2 mapped only {info2['mapped']}")
    check(bool(np.isfinite(tab2["est_counts"]).all())
          and bool(np.isfinite(tab2["tpm"]).all()), "config-2 non-finite")
    mass = float(tab2["est_counts"].sum())
    check(abs(mass - info2["mapped"]) < 1e-3 * info2["mapped"],
          f"config-2 EM mass {mass} != mapped {info2['mapped']}")
    log(f"[c2 check] {tab2['target_id'].size} transcripts, est_counts sum "
        f"{mass:.1f} vs mapped {info2['mapped']}, TPM sum "
        f"{float(tab2['tpm'].sum()):.1f}")

    # fast mode: config 1 against the port's plain fast path on the CPU
    _, info3, l3 = run_infer(work, "c1", [str(work / "c1.fq"),
                                          "--probe-sample", "16"],
                             unused=("em", *STRIDED), name="c1_fast")
    t0 = time.perf_counter()
    ref3 = cpu_map(work, index, MapConfig(batch_size=B, probe_sample=16))
    check(info3["probe_sample"] == 16
          and (info3["mapped"], info3["unmapped"])
          == (ref3["mapped"], ref3["unmapped"]),
          f"config-1 fast mapped {info3['mapped']} / unmapped "
          f"{info3['unmapped']} != the plain fast path on the CPU "
          f"{ref3['mapped']} / {ref3['unmapped']}")
    log(f"[c1_fast reference] mapped {info3['mapped']}, unmapped "
        f"{info3['unmapped']} == the plain fast path on the CPU (dense: "
        f"{info['mapped']} / {info['unmapped']}; "
        f"{time.perf_counter() - t0:.1f} s)")
    _, info4, l4 = run_infer(work, "c2", [
        str(work / "c2_1.fq"), "--mates", str(work / "c2_2.fq"),
        "--sig-table-bits", "22", "--probe-sample", "16"],
        unused=("em", *STRIDED), name="c2_fast")
    fld4 = info4["fld"]
    check(fld4 is not None and abs(fld4["mean"] - 200.0) < 10.0
          and abs(fld4["sd"] - 20.0) < 10.0 and fld4["samples"] > 1000,
          f"config-2 fast FLD estimate {fld4}")
    check(info4["total_reads"] == BATCHES * B
          and info4["mapped"] > 0.8 * BATCHES * B,
          f"config-2 fast mapped only {info4['mapped']}")
    log(f"[c2_fast check] mapped {info4['mapped']} (dense "
        f"{info2['mapped']}), unmapped {info4['unmapped']} (dense "
        f"{info2['unmapped']}); FLD mean {fld4['mean']:.6f}, sd "
        f"{fld4['sd']:.6f}, {fld4['samples']} samples")
    # strided mode, s = 4, both worlds: K7 in place of K2; config 1's
    # MapResult on the card against the plain strided path on the CPU
    _, info5, l5 = run_infer(work, "c1", [str(work / "c1.fq"),
                                          "--probe-stride", "4"],
                             unused=("em", "lookup", *FAST),
                             name="c1_strided")
    t0 = time.perf_counter()
    scfg = MapConfig(batch_size=B, probe_stride=4)
    ref5, card5 = cpu_map(work, index, scfg), cpu_map(work, index, scfg,
                                                      DEVICE)
    r, c = ref5["result"], card5["result"]
    check(np.array_equal(r.sigs, c.sigs)
          and np.array_equal(r.sig_counts, c.sig_counts)
          and (r.total_reads, r.mapped, r.overflow, r.collisions)
          == (c.total_reads, c.mapped, c.overflow, c.collisions),
          "config-1 strided MapResult on the card differs from the plain "
          "strided path on the CPU")
    check(info5["probe_stride"] == 4
          and (info5["mapped"], info5["unmapped"])
          == (ref5["mapped"], ref5["unmapped"]),
          f"config-1 strided mapped {info5['mapped']} / unmapped "
          f"{info5['unmapped']} != the plain strided path on the CPU "
          f"{ref5['mapped']} / {ref5['unmapped']}")
    log(f"[c1_strided reference] MapResult on the card equal to the plain "
        f"strided path on the CPU ({r.sigs.shape[0]} signatures, mapped "
        f"{r.mapped}); infer mapped {info5['mapped']}, unmapped "
        f"{info5['unmapped']} (dense {info['mapped']} / {info['unmapped']}, "
        f"difference {info5['mapped'] - info['mapped']}; "
        f"{time.perf_counter() - t0:.1f} s)")
    _, info6, l6 = run_infer(work, "c2", [
        str(work / "c2_1.fq"), "--mates", str(work / "c2_2.fq"),
        "--sig-table-bits", "22", "--probe-stride", "4"],
        unused=("em", "lookup", *FAST), name="c2_strided")
    fld6 = info6["fld"]
    check(fld6 is not None and abs(fld6["mean"] - 200.0) < 10.0
          and info6["total_reads"] == BATCHES * B
          and info6["mapped"] > 0.8 * BATCHES * B,
          f"config-2 strided mapped {info6['mapped']}, FLD {fld6}")
    log(f"[c2_strided check] mapped {info6['mapped']} (dense "
        f"{info2['mapped']}, difference {info6['mapped'] - info2['mapped']})"
        f", unmapped {info6['unmapped']} (dense {info2['unmapped']}); FLD "
        f"mean {fld6['mean']:.6f}, sd {fld6['sd']:.6f}")
    # A3: one launch a fixed point, no host read between its blocks
    runs = (l1, l2, l3, l4, l5, l6)
    a3 = [l["em_csr"] for l in runs]
    check(a3 == [1, 2, 1, 1, 1, 1], f"A3 launches per infer run {a3}, "
          "expected one a fixed point: [1, 2, 1, 1, 1, 1]")
    infos = {"c1": info, "c2": info2, "c1 fast": info3, "c2 fast": info4}
    return {k: sum(l[k] for l in runs) for k in l1}, infos, ref["result"]


def fuse_check(work: Path, injected) -> dict:
    """``fuse`` at config 2 (the index with its gene map) on the chimeric
    pairs and the first config-2 batch, through the CLI: every injected
    gene pair must be a candidate with at least its injected support; the
    other candidates are counted. Then ``fusion.detect_fusions_files``
    with ``MapConfig(probe_stride=4)`` (strided + fusion; the CLI has no
    stride flag) must give the same table and tallies. Returns the
    launches of the two runs, each counted from 0."""
    from seekmer_tpu_torch import MapConfig, cli, fusion
    from seekmer_tpu_torch.io.writer import write_fusions

    f1, f2 = str(work / "fuse_1.fq"), str(work / "fuse_2.fq")
    out = work / "fuse_out"
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["fuse", str(work / "c2.npz"), str(out), f1, "--mates", f2,
                   "--sig-table-bits", "22", "--device", DEVICE])
    wall = time.perf_counter() - t0
    dense = cli.kernel_launches()
    check(rc == 0, f"fuse exit {rc}")
    for kernel, n in dense.items():
        used = kernel in ("pack", "lookup", "signature", "accumulate")
        check((n > 0) == used, f"fuse: kernel {kernel} launched {n} times")
    info = json.loads((out / "run_info.json").read_text())
    table = (out / "fusions.tsv").read_text().splitlines()
    rows = {tuple(sorted(r.split("\t")[:2])): r.split("\t")
            for r in table[1:]}
    support = []
    for ga, gb in injected:
        row = rows.get(tuple(sorted((ga, gb))))
        check(row is not None and int(row[2]) >= FUSION_PAIRS,
              f"fuse: injected pair {ga}, {gb} not called with its "
              f"{FUSION_PAIRS} pairs: {row}")
        support.append(int(row[2]) + int(row[3]))
    log(f"[fuse config 2] {info['pairs_total']} pairs ({FUSION_GENES} gene "
        f"pairs x {FUSION_PAIRS} chimeric + the first config-2 batch): "
        f"{info['candidates']} candidates, every injected pair called "
        f"(support {min(support)}-{max(support)}), {len(rows) - len(injected)}"
        f" other candidates; concordant {info['concordant']}, same-gene "
        f"{info['same_gene_discordant']}, ambiguous {info['ambiguous']}, "
        f"unresolved {info['unresolved']}, split reads {info['split_reads']};"
        f" CLI wall {wall:.1f} s, kernel launches {dense}")

    index = load_index(work, "c2")
    reset_launches()
    rep = fusion.detect_fusions_files(
        index, [f1], [f2], cfg=MapConfig(sig_table_bits=22, probe_stride=4),
        device=DEVICE)
    strided = cli.kernel_launches()
    check(strided["strided"] > 0 and strided["lookup"] == 0,
          f"strided fusion run: kernel launches {strided}")
    write_fusions(str(work / "fuse_s4.tsv"), rep)
    same = ((work / "fuse_s4.tsv").read_text().splitlines() == table
            and (rep.pairs_total, rep.concordant, rep.same_gene_discordant,
                 rep.ambiguous, rep.unresolved, rep.split_reads)
            == tuple(info[k] for k in ("pairs_total", "concordant",
                                       "same_gene_discordant", "ambiguous",
                                       "unresolved", "split_reads")))
    check(same, "fusion with probe_stride=4 gives another report than fuse")

    log(f"[fuse config 2 s=4] detect_fusions_files with probe_stride=4: the "
        f"same table and tallies as fuse; kernel launches {strided}")
    return {k: dense[k] + strided[k] for k in dense}


def cpu_reference(work: Path, index, em_cfg) -> dict:
    """The config-1 run on the CPU through the port's plain versions (which
    the CPU tests hold against the JAX package and its float64 oracle):
    mapped and unmapped reads, the ECs, and float64 EM to the TPM."""
    import dataclasses

    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.em.em import build_ec_table, run_em, tpm_from_alpha

    ref = cpu_map(work, index, MapConfig(batch_size=B))
    x64 = dataclasses.replace(em_cfg, use_x64=True)
    ec = build_ec_table(ref["members"], ref["counts"], index.num_transcripts,
                        dtype=torch.float64, device="cpu")
    alpha, _ = run_em(ec, index.lengths, x64)
    return dict(ref, tpm=tpm_from_alpha(alpha, index.lengths, x64).numpy())


def cpu_map(work: Path, index, cfg, device="cpu") -> dict:
    """The config-1 reads mapped under ``cfg`` on ``device`` (the CPU: the
    port's plain versions): the MapResult, mapped and unmapped counted as
    the Quantifier counts them (reads whose signature resolves to no
    transcript are dropped from the mapped), and the resolved ECs."""
    from seekmer_tpu_torch.io.fastq import batch_reads_native
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.prefetch import device_put_batches

    mapper = Mapper(index, cfg, device=device)
    result = mapper.run(device_put_batches(
        batch_reads_native([str(work / "c1.fq")], cfg), mapper.device))
    members, counts, dropped = resolve_signatures(result, index)
    return {"mapped": result.mapped - dropped,
            "unmapped": result.total_reads - result.mapped + dropped,
            "members": members, "counts": counts, "result": result}


def em_tpm_error(index, ref, em_cfg) -> float:
    import numpy as np

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em.em import build_ec_table, run_em, tpm_from_alpha

    ec = build_ec_table(ref["members"], ref["counts"], index.num_transcripts,
                        device=DEVICE)
    alpha, _ = run_em(ec, index.lengths, em_cfg)
    tpm = tpm_from_alpha(alpha, index.lengths, em_cfg).cpu().numpy()
    # steady EM rate: a fixed 2000-iteration run after the one above warmed
    # up every kernel (bench.py's protocol for EM iterations/s)
    fixed = EMConfig(rel_tol=0.0, min_iters=2000, max_iters=2000)
    t0 = time.perf_counter()
    run_em(ec, index.lengths, fixed)[0].sum().item()
    dt = time.perf_counter() - t0
    log(f"[c1 EM steady] 2000 iterations, nnz {ec.ec_ids.numel()}, "
        f"{ec.num_ecs} ECs: {dt:.3f} s, {2000 / dt:.1f} it/s")
    return float(np.abs(tpm - ref["tpm"]).max())


def device_busy(prof):
    """Device busy ms of a trace, the union of its kernel and copy
    intervals, and the device ms and count per kernel or copy name."""
    from torch.autograd import DeviceType

    spans, per = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end  # us
        spans.append((a, b))
        ms, n = per.get(e.name, (0.0, 0))
        per[e.name] = (ms + (b - a) / 1e3, n + 1)
    check(bool(spans), "the profiler saw no device time")
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy / 1e3, per


def traced(fn, trace: bool):
    """Run ``fn()`` (which synchronizes the card) and return its wall ms
    and, when ``trace``, its torch.profiler trace."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if trace else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        out = fn()
        wall = (time.perf_counter() - t0) * 1e3
    return out, wall, prof


def report_stage(name: str, run):
    """Warm ``run(trace)`` up, time it untraced, then traced; print the
    walls, the device busy share of the traced wall and the device time
    per kernel or copy."""
    run(False)
    _, wall, _ = run(False)
    out, twall, prof = run(True)
    busy, per = device_busy(prof)
    log(f"[profile {name}] untraced wall {wall:.6f} ms; traced wall "
        f"{twall:.6f} ms, device busy {busy:.6f} ms = {busy / twall:.6f} of "
        f"the traced wall")
    for k, (ms, n) in sorted(per.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile {name}]   {ms:10.6f} ms x {n:5d}  {k[:90]}")
    return out


def profile_stages(work: Path, keep_inputs=None) -> dict:
    """Trace the map stage (dense, then fast at s = 16, then strided at
    s = 4), a fixed
    480-iteration EM and a fixed 480-iteration 100-replicate bootstrap on
    both worlds; on the world that takes the batched CSR bootstrap route,
    hold A3 against its plain version and time it first
    (``compare_csr_em``); hold A4 against its plain version at config
    2's EC table (``check_ec_sum``); return their records as {"A3":
    record, "A4": record}. With
    ``keep_inputs``, write config 2's EC table to
    ``keep_inputs``.c2_ec.npz."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig, MapConfig
    from seekmer_tpu_torch.em.bootstrap import run_bootstrap
    from seekmer_tpu_torch.em.em import build_ec_table, run_em, use_dense
    from seekmer_tpu_torch.io.fastq import (batch_read_pairs_native,
                                            batch_reads_native)
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.prefetch import device_put_batches, prefetch

    dev = torch.device(DEVICE)
    out = {}
    fixed = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480)
    boot = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480,
                    bootstrap_samples=100, bootstrap_seed=1)
    for tag, paired, bits in (("c1", False, 20), ("c2", True, 22)):
        index = load_index(work, tag)
        cfg = MapConfig(batch_size=B, sig_table_bits=bits, paired_end=paired)

        def map_run(trace, cfg=cfg):
            # as Quantifier.quantify_batches: the index upload is set-up,
            # the timed region is Mapper.run over the prefetched batches
            mapper = Mapper(index, cfg, device=dev)
            if paired:
                raw = batch_read_pairs_native([str(work / "c2_1.fq")],
                                              [str(work / "c2_2.fq")], cfg)
            else:
                raw = batch_reads_native([str(work / "c1.fq")], cfg)
            batches = prefetch(device_put_batches(raw, dev), depth=4)
            torch.cuda.synchronize()
            return traced(lambda: (mapper.run(batches),
                                   torch.cuda.synchronize())[0], trace)

        result = report_stage(f"{tag} map", map_run)
        fast = dataclasses.replace(cfg, probe_sample=16)
        report_stage(f"{tag} map fast s=16",
                     lambda trace: map_run(trace, fast))
        strided = dataclasses.replace(cfg, probe_stride=4)
        report_stage(f"{tag} map strided s=4",
                     lambda trace: map_run(trace, strided))
        members, counts, _ = resolve_signatures(result, index)
        if keep_inputs and paired:
            np.savez(f"{keep_inputs}.c2_ec.npz", counts=counts,
                     lengths=index.lengths, sizes=[m.size for m in members],
                     members=np.concatenate(members))
        ec = build_ec_table(members, counts, index.num_transcripts,
                            device=dev)
        dense = use_dense(ec, boot, 100)
        if not dense:
            out["A3"] = compare_csr_em(ec, index.lengths)
        if paired:
            out["A4"] = check_ec_sum(
                ec, index.lengths,
                keep_inputs and f"{keep_inputs}.a4.pt")
        log(f"[profile {tag} em] nnz {ec.ec_ids.numel()}, {ec.num_ecs} ECs")
        report_stage(f"{tag} em", lambda trace: traced(lambda: (
            run_em(ec, index.lengths, fixed)[0].sum().item()), trace))
        log(f"[profile {tag} bootstrap] 100 replicates, 480 iterations, "
            f"{'dense (K4)' if dense else 'batched CSR (A3)'} route")
        report_stage(f"{tag} bootstrap", lambda trace: traced(lambda: (
            run_bootstrap(ec, index.lengths, boot)[0].sum().item()), trace))
    check("A3" in out and "A4" in out,
          "no world took the batched CSR route, or A4 was not checked")
    return out


# ---- the compiled single-core CPU baseline -------------------------------

BASELINE_PASSES = 5  # timed passes an arm; the best is the rate (bench.py)


def host_line() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (its model name, and its
    vendor, family, model number and clock, which a virtual machine shows
    where it hides the name) and the cores this process may use."""
    import os

    cpu = {}
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if not line.strip():
                break  # the first processor's block
            key, _, value = line.partition(":")
            cpu[key.strip()] = value.strip()
    return (f"CPU model name {cpu.get('model name')!r} "
            f"({cpu.get('vendor_id')} family {cpu.get('cpu family')} model "
            f"{cpu.get('model')}, {cpu.get('cpu MHz')} MHz), "
            f"{len(os.sched_getaffinity(0))} cores usable")


def baseline_arm(tag: str, base, codes, use_skip: bool):
    """One warm-up map of 256 rows, then the best of BASELINE_PASSES timed
    passes of ``codes``; prints every pass's rate. Returns (reads/s, mapped
    a pass)."""
    base.map(codes[:256], use_skip=use_skip)
    rates, mapped = [], set()
    for _ in range(BASELINE_PASSES):
        t0 = time.perf_counter()
        mapped.add(base.map(codes, use_skip=use_skip))
        rates.append(codes.shape[0] / (time.perf_counter() - t0))
    check(len(mapped) == 1, f"{tag}: mapped differs between passes {mapped}")
    n = mapped.pop()
    log(f"[{tag}] {'skip' if use_skip else 'dense'} arm: best "
        f"{max(rates):.1f} reads/s of "
        f"{', '.join(f'{r:.1f}' for r in rates)}; {n} / {codes.shape[0]} "
        f"mapped")
    return max(rates), n


def baseline_ratios(tag: str, where: str, mates: int, step_ms: float,
                    fast_ms: float, run, fast_run, dense: float,
                    skip: float) -> None:
    """The port's reads/s over 10x the baseline's: the device map step of
    one batch and the map stage as ``infer`` ran it (``timings.map_s``)
    against the dense arm, fast mode at s = 16 against the skip arm; a
    read (pair) counts ``mates`` reads, as the baseline maps each mate."""
    rows = mates * B
    for what, rate, arm, base in (
            ("device map step, dense", rows / step_ms * 1e3, "dense", dense),
            ("map stage as infer ran it, dense", mates * run["total_reads"]
             / run["timings"]["map_s"], "dense", dense),
            ("device map step, fast s=16", rows / fast_ms * 1e3, "skip",
             skip),
            ("map stage as infer ran it, fast s=16", mates
             * fast_run["total_reads"] / fast_run["timings"]["map_s"],
             "skip", skip)):
        log(f"[{tag}] {what}: {rate:.1f} reads/s over 10 x the {arm} arm "
            f"({10 * base:.1f} reads/s) = {rate / (10 * base):.6f}; {where}")


def baseline_phase(work: Path, batches, card: str, steps: dict, infos: dict,
                   c1_raw) -> dict:
    """``[baseline c1]``, ``[baseline c2]``: the compiled single-core CPU
    baseline (``native/cpu_baseline``) on the card's host, its dense and
    skip arms timed as ``bench.py`` times them, its dense arm's mapped and
    distinct signatures held to the port's raw ``MapResult`` on the same
    rows, and the port's reads/s over 10x its own. Config 1: every read of
    c1.fq against the plain path on the CPU (``cpu_reference``), timed on
    the first batch; config 2: the first pair batch's 2 B mate rows, each
    a single-end read, against the port's dense ``Mapper`` on the card.
    Returns that run's launches."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.io.fastq import ReadBatch
    from seekmer_tpu_torch.map.driver import Mapper
    from seekmer_tpu_torch.native.cpu_baseline import CpuBaselineMapper
    from seekmer_tpu_torch.native.packer import stream_packed

    t_phase = time.perf_counter()
    where = f"host {host_line()}; card {card}"
    max_ecs = MapConfig().max_ecs_per_read
    rows = np.concatenate([c for c, _ in stream_packed(
        str(work / "c1.fq"), READ_LEN, B)])
    t0 = time.perf_counter()
    with CpuBaselineMapper(load_index(work, "c1"),
                           sig_bits=20) as base:
        build_s = time.perf_counter() - t0
        mapped = base.map(rows, max_ecs)
        got = (rows.shape[0], mapped, base.distinct_signatures)
        want = (c1_raw.total_reads, c1_raw.mapped, c1_raw.sigs.shape[0])
        check(got == want and c1_raw.overflow == 0,
              f"[baseline c1] reads, mapped, distinct signatures {got} != "
              f"the plain path's raw MapResult on the CPU {want}")
        log(f"[baseline c1] {where}; table built in {build_s:.3f} s; all "
            f"{rows.shape[0]} reads of c1.fq: mapped {mapped}, "
            f"{base.distinct_signatures} distinct signatures == the plain "
            f"path's raw MapResult on the CPU")
        dense, n_dense = baseline_arm("baseline c1", base, batches[0], False)
        skip, n_skip = baseline_arm("baseline c1", base, batches[0], True)
    check(abs(n_skip - n_dense) <= 1e-3 * batches[0].shape[0],
          f"[baseline c1] skip arm mapped {n_skip}, dense {n_dense}")
    log(f"[baseline c1] skip arm mapped minus dense arm mapped: "
        f"{n_skip - n_dense} of {batches[0].shape[0]} reads")
    baseline_ratios("baseline c1", where, 1, steps["c1"], steps["c1 fast"],
                    infos["c1"], infos["c1 fast"], dense, skip)

    c2_index = load_index(work, "c2")
    mates = np.concatenate(batches[1])  # each mate a single-end read
    ln = np.full(B, READ_LEN, np.int32)
    ones = np.ones(B, np.int32)
    t0 = time.perf_counter()
    reset_launches()
    port = Mapper(c2_index, MapConfig(batch_size=B, sig_table_bits=22),
                  device=DEVICE).run([ReadBatch(m, ln, ones)
                                      for m in batches[1]])
    launches = read_launches("baseline c2")
    torch.cuda.empty_cache()
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with CpuBaselineMapper(c2_index, sig_bits=22) as base:
        build_s = time.perf_counter() - t0
        log(f"[baseline c2] {where}; the port's Mapper (upload and 2 "
            f"batches) {port_s:.3f} s, the baseline's table built in "
            f"{build_s:.3f} s")
        dense, n_dense = baseline_arm("baseline c2", base, mates, False)
        got = (n_dense, base.distinct_signatures)
        want = (port.mapped, port.sigs.shape[0])
        check(got == want and port.overflow == 0
              and port.total_reads == mates.shape[0],
              f"[baseline c2] mapped, distinct signatures {got} != the "
              f"port's dense Mapper on the card {want}")
        log(f"[baseline c2] {mates.shape[0]} mate rows: mapped {n_dense}, "
            f"{got[1]} distinct signatures == the port's single-end dense "
            f"Mapper on the card (launches {launches})")
        skip, n_skip = baseline_arm("baseline c2", base, mates, True)
    check(abs(n_skip - n_dense) <= 1e-3 * mates.shape[0],
          f"[baseline c2] skip arm mapped {n_skip}, dense {n_dense}")
    log(f"[baseline c2] skip arm mapped minus dense arm mapped: "
        f"{n_skip - n_dense} of {mates.shape[0]} mate rows")
    baseline_ratios("baseline c2", where, 2, steps["c2"],
                    steps["c2 fast"], infos["c2"], infos["c2 fast"], dense,
                    skip)
    log(f"[baseline] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- checkpoints, the pack cache, traces and reads in memory ------------

MAIN = ("pack", "lookup", "signature", "accumulate")  # K1, K2, K3, A1


def read_launches(name: str, need=MAIN) -> dict:
    """The launch counts since ``reset_launches``; every kernel in
    ``need`` must have launched."""
    from seekmer_tpu_torch import cli

    launches = cli.kernel_launches()
    for kernel in need:
        check(launches[kernel] > 0, f"{name}: kernel {kernel} was never "
              f"launched")
    return launches


class Crash(Exception):
    """Stops a run where a test of resume wants it stopped."""


class Spy:
    """Wraps ``cls.name`` while in a ``with``: records each call's seconds
    and result, and the object of the last (``obj``), and raises
    ``Crash`` after the ``crash_after``-th call."""

    def __init__(self, cls, name, crash_after=None):
        self.cls, self.name, self.crash_after = cls, name, crash_after
        self.calls = []
        self.obj = None

    def __enter__(self):
        real = self.real = getattr(self.cls, self.name)
        spy = self

        def wrapped(obj, *a, **k):
            t0 = time.perf_counter()
            out = real(obj, *a, **k)
            spy.obj = obj
            spy.calls.append((time.perf_counter() - t0, out))
            if spy.crash_after is not None and len(spy.calls) == \
                    spy.crash_after:
                raise Crash
            return out

        setattr(self.cls, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.real)


def c2_pipeline(**em):
    from seekmer_tpu_torch import EMConfig, MapConfig, PipelineConfig

    return PipelineConfig().replace(
        map=MapConfig(batch_size=B, sig_table_bits=22, paired_end=True),
        em=EMConfig(**em))


def same_map(a, b) -> bool:
    """Two MapResults with the same signature -> count table and counts."""
    import numpy as np

    return (np.array_equal(a.sigs, b.sigs)
            and np.array_equal(a.sig_counts, b.sig_counts)
            and (a.total_reads, a.mapped, a.overflow, a.collisions)
            == (b.total_reads, b.mapped, b.overflow, b.collisions))


def checkpoint_map(work: Path, card: str):
    """``[checkpoint c2 map]``: config 2's paired world (4 batches, FLD
    estimated), ``quantify_files`` with a checkpoint every batch, stopped
    after batch 2's save, resumed in a fresh Quantifier; against the run
    without a checkpoint. Returns (launches of the resumed run, the
    uninterrupted run's QuantResult and MapResult)."""
    import numpy as np

    from seekmer_tpu_torch.map.driver import Mapper
    from seekmer_tpu_torch.models.quantifier import Quantifier

    index = load_index(work, "c2")
    files = ([str(work / "c2_1.fq")], [str(work / "c2_2.fq")])
    ckpt = str(work / "c2_map.ckpt.npz")
    cfg = c2_pipeline()
    with Spy(Mapper, "finalize") as fin:
        plain = Quantifier(index, cfg, DEVICE).quantify_files(*files)
    with Spy(Mapper, "save_checkpoint", crash_after=2) as saves:
        try:
            Quantifier(index, cfg, DEVICE).quantify_files(
                *files, checkpoint_path=ckpt, checkpoint_every=1)
            check(False, "the interrupted config-2 run was not stopped")
        except Crash:
            pass
    size = Path(ckpt).stat().st_size
    reset_launches()
    with Spy(Mapper, "restore_checkpoint") as restore, \
            Spy(Mapper, "save_checkpoint") as saves2, \
            Spy(Mapper, "finalize") as fin2:
        t0 = time.perf_counter()
        got = Quantifier(index, cfg, DEVICE).quantify_files(
            *files, checkpoint_path=ckpt, checkpoint_every=1)
        wall = time.perf_counter() - t0
    launches = read_launches("[checkpoint c2 map]",
                             (*MAIN, "em_csr", "ec_sum"))
    a, b = fin2.calls[0][1], fin.calls[0][1]
    check(same_map(a, b) and (got.total_reads, got.mapped, got.unmapped)
          == (plain.total_reads, plain.mapped, plain.unmapped),
          "the resumed config-2 run's signature counts differ from the "
          "uninterrupted run's")
    check((got.fld_mean, got.fld_sd, got.fld_samples)
          == (plain.fld_mean, plain.fld_sd, plain.fld_samples)
          and got.fld_samples is not None,
          "the resumed config-2 run's FLD estimate differs")
    check(np.array_equal(got.est_counts, plain.est_counts),
          "the resumed config-2 run's est_counts bits differ")
    save_s = [t for t, _ in saves.calls + saves2.calls]
    log(f"[checkpoint c2 map] resumed after batch 2's save: mapped "
        f"{got.mapped} / {got.total_reads}, {a.sigs.shape[0]} signatures, "
        f"est_counts bit-equal, FLD mean {got.fld_mean:.6f} from "
        f"{got.fld_samples} pairs (restored with the table); "
        f"{len(save_s)} saves of {size} bytes "
        f"(sig_table_bits 22), {min(save_s):.6f}-{max(save_s):.6f} s a "
        f"save (mean {sum(save_s) / len(save_s):.6f}); restore "
        f"{restore.calls[0][0]:.6f} s; resumed run {wall:.3f} s, map "
        f"{got.timings['map_s']:.6f} s (uninterrupted, no checkpoint: "
        f"{plain.timings['map_s']:.6f} s); {card}")
    return launches, plain, b


def checkpoint_em(result, index, card: str) -> dict:
    """``[checkpoint c2 em]``: on config 2's EC table, ``run_em`` (float32
    and float64) and the B 100 bootstrap (``run_bootstrap``, float32, and
    ``batched_em`` on the same resample in float64), each stopped at its
    first snapshot and resumed: one A3 launch's bits and iteration count.
    Then the snapshotted fixed point's pieces and its CUDA-event ms beside
    one launch. Returns the launches of the resumed runs."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em import em as tem
    from seekmer_tpu_torch.em.bootstrap import (batched_em, resample_counts,
                                                run_bootstrap)
    from seekmer_tpu_torch.em.em import build_ec_table, run_em
    from seekmer_tpu_torch.map.driver import resolve_signatures
    from seekmer_tpu_torch.ops import em_csr_cuda

    members, counts, _ = resolve_signatures(result, index)
    T = index.num_transcripts
    total = {}

    def first_snapshot(fn):
        seen = []

        def on_sync(a, it):
            seen.append((a, it))
            raise Crash

        try:
            fn(on_sync)
            check(False, "the snapshot hook was never called")
        except Crash:
            pass
        return seen[0]

    def resumed(tag, fn):
        """fn(alpha_init, it_init, on_sync) -> (alpha, it)."""
        one, it1 = fn(None, 0, None)
        a0, it0 = first_snapshot(lambda f: fn(None, 0, f))
        reset_launches()
        got, it = fn(a0, it0, None)
        launches = read_launches(f"[checkpoint c2 em] {tag}", ("em_csr",))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        check(it == it1 and torch.equal(got, one),
              f"{tag} resumed at {it0}: {it} iterations, bits "
              f"{'equal' if torch.equal(got, one) else 'differ'}; one "
              f"launch {it1}")
        log(f"[checkpoint c2 em] {tag}: stopped at its first snapshot "
            f"(iteration {it0}), resumed: {it} iterations, bits equal to "
            f"one launch's ({it1} iterations)")

    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        ec = build_ec_table(members, counts, T, dtype=dt, device=DEVICE)
        cfg = EMConfig(use_x64=dt == torch.float64)
        resumed(f"run_em {name}", lambda a, i, f: run_em(
            ec, index.lengths, cfg, alpha_init=a, it_init=i, on_sync=f))
    ec = build_ec_table(members, counts, T, device=DEVICE)
    boot = EMConfig(bootstrap_samples=100, bootstrap_seed=1, backend="csr")
    resumed("run_bootstrap B 100 f32", lambda a, i, f: run_bootstrap(
        ec, index.lengths, boot, alpha_init=a, it_init=i, on_sync=f))
    gen = torch.Generator(device=ec.counts.device)
    gen.manual_seed(1)
    cmat = resample_counts(ec.counts, 100, gen).double()
    resumed("batched_em B 100 f64", lambda a, i, f: batched_em(
        cmat, ec.ec_ids, ec.txp_ids, index.lengths, ec.num_ecs, T, boot,
        alpha_init=a, it_init=i, on_sync=f))

    # the cost of snapshots: the fixed point in pieces beside one launch
    lay = tem.csr_layout(ec.ec_ids, ec.txp_ids, ec.num_ecs, T)
    inv = 1.0 / tem.effective_lengths(index.lengths, boot, torch.float32,
                                      ec.counts.device)
    counts_b = cmat.float().t().contiguous()
    alpha0 = tem.even_split(counts_b.sum(dim=0), T)[None, :].expand(
        T, 100).contiguous()
    args = (alpha0, counts_b, inv, lay, boot, False)

    def event_ms(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    one_ms, one = event_ms(lambda: em_csr_cuda.em_fixed_point(*args))
    rows = []
    for target in (tem.SYNC_TARGET_S, 0.0):
        syncs = []
        saved, tem.SYNC_TARGET_S = tem.SYNC_TARGET_S, target
        try:
            ms, got = event_ms(lambda: tem.csr_fixed_point(
                *args, on_sync=lambda a, it: syncs.append(it)))
        finally:
            tem.SYNC_TARGET_S = saved
        check(torch.equal(got[0], one[0]) and got[1:] == one[1:],
              f"A3 in pieces (target {target} s) differs from one launch")
        rows.append(f"{len(syncs) + 1} pieces at a {target} s target "
                    f"{ms:.6f} ms")
    log(f"[checkpoint c2 em] A3 fixed point, B 100 f32, {one[1]} "
        f"iterations, CUDA events around the call: one launch "
        f"{one_ms:.6f} ms; in pieces (the snapshot's D2H copy of the (T, "
        f"B) iterate between two): {'; '.join(rows)}; {card}")
    return total


def file_text(path) -> str:
    return Path(path).read_text()


def pack_cache_phase(work: Path, card: str, plain, plain_map):
    """``[pack cache c2]``: ``infer --pack-cache DIR`` on config 2 without
    bootstrap, the build run then the hit run, against the run without the
    cache; a checkpointed run on the cached batches, stopped after its
    second save and resumed; then a rebuilt cache, on which that
    checkpoint is refused (fault 2). Returns the launches of the hit
    run."""
    import numpy as np

    from seekmer_tpu_torch.map.driver import Mapper
    from seekmer_tpu_torch.models.quantifier import Quantifier

    cache = work / "c2.smpack"
    argv = [str(work / "c2_1.fq"), "--mates", str(work / "c2_2.fq"),
            "--sig-table-bits", "22", "--batch-size", str(B),
            "--pack-cache", str(cache)]
    out_b, info_b, _ = run_infer(work, "c2", argv, unused=("em", *FAST,
                                                            *STRIDED),
                                 name="c2_cache_build")
    meta = json.loads((cache / "meta.json").read_text())
    nbytes_ = sum(f.stat().st_size for f in cache.iterdir())
    out_h, info_h, launches = run_infer(work, "c2", argv,
                                        unused=("em", *FAST, *STRIDED),
                                        name="c2_cache_hit")
    ref = work / "c2_out"  # config 2 dense without the cache (end_to_end)
    tsv = file_text(ref / "abundance.tsv")
    ref_info = json.loads((ref / "run_info.json").read_text())
    check(file_text(out_b / "abundance.tsv") == tsv
          and file_text(out_h / "abundance.tsv") == tsv
          and info_b["mapped"] == info_h["mapped"] == ref_info["mapped"],
          "config 2 through the pack cache differs from the FASTQ run")
    tb, th, tr = (i["timings"] for i in (info_b, info_h, ref_info))
    log(f"[pack cache c2] {len(meta['batches'])} batches, {nbytes_} bytes "
        f"(build {meta['build_id']}); abundance.tsv and mapped "
        f"{info_h['mapped']} equal to the FASTQ run's; map stage: FASTQ "
        f"{tr['map_s']:.6f} s ({tr['reads_per_s']:.0f} pairs/s), build "
        f"{tb['map_s']:.6f} s ({tb['reads_per_s']:.0f} pairs/s), hit "
        f"{th['map_s']:.6f} s ({th['reads_per_s']:.0f} pairs/s); {card}")

    index = load_index(work, "c2")
    files = ([str(work / "c2_1.fq")], [str(work / "c2_2.fq")])
    ckpt = str(work / "c2_cache.ckpt.npz")
    cfg = c2_pipeline()
    with Spy(Mapper, "save_checkpoint", crash_after=2):
        try:
            Quantifier(index, cfg, DEVICE).quantify_files(
                *files, checkpoint_path=ckpt, checkpoint_every=1,
                pack_cache=str(cache))
            check(False, "the interrupted cached run was not stopped")
        except Crash:
            pass
    with Spy(Mapper, "finalize") as fin:
        got = Quantifier(index, cfg, DEVICE).quantify_files(
            *files, checkpoint_path=ckpt, checkpoint_every=1,
            pack_cache=str(cache))
    check(same_map(fin.calls[0][1], plain_map)
          and np.array_equal(got.est_counts, plain.est_counts),
          "the resumed cached config-2 run differs from the FASTQ run")
    (cache / "meta.json").unlink()  # the next run rebuilds the cache
    Quantifier(index, cfg, DEVICE).quantify_files(*files,
                                                  pack_cache=str(cache))
    rebuilt = json.loads((cache / "meta.json").read_text())["build_id"]
    try:
        Quantifier(index, cfg, DEVICE).quantify_files(
            *files, checkpoint_path=ckpt, pack_cache=str(cache))
        check(False, "a checkpoint of another cache build was accepted")
    except ValueError as e:
        check("rebuilt since the checkpoint" in str(e),
              f"the stale cache checkpoint was refused for another cause: "
              f"{e}")
    log(f"[pack cache c2] checkpointed run on the cached batches stopped "
        f"after its second save and resumed: signature counts and "
        f"est_counts bits equal to the FASTQ run's; cache rebuilt (build "
        f"{rebuilt}): that checkpoint refused (fault 2)")
    return launches


def trace_events(path):
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def union_ms(spans) -> float:
    busy, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            busy += b - max(a, reach)
            reach = b
    return busy / 1e3


def trace_phase(work: Path, card: str, tag: str, argv, unused) -> dict:
    """``[trace <tag>]``: ``infer --trace-dir D``; the trace must parse,
    hold K1, K2, K3 and A1's kernels and every stage range; prints each
    range's host ms beside run_info.json's timing for it and the map
    stage's split: the prefetch thread's ingest and upload, the device's
    busy time (the union of its kernel and copy intervals) within the map
    range and its largest kernels and copies. Returns the run's
    launches."""
    trace = work / f"{tag}_trace"
    out, info, launches = run_infer(work, tag, [*argv, "--trace-dir",
                                                str(trace)],
                                    unused=unused, name=f"{tag}_traced")
    events = trace_events(trace / "infer.trace.json")
    ranges = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(e)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    for k in ("pack_kernel", "lookup_kernel", "sig_kernel", "fold_kernel"):
        if not any(k in e["name"] for e in kernels):
            # what the trace does hold, for the diagnosis of a missing kernel
            infer = ranges.get("infer", [{"ts": 0}])[0]["ts"]
            cats = {}
            for e in events:
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            names = sorted({e["name"][:40] for e in kernels})[:8]
            first = min((e["ts"] for e in kernels), default=None)
            check(False, f"[trace {tag}] no {k} in the trace: "
                  f"{len(kernels)} kernels, the first "
                  f"{None if first is None else (first - infer) / 1e3} ms "
                  f"after the infer range's start, names {names}; events "
                  f"by category {cats}; launches {launches}")
    stages = ["map", "resolve", "em", "ingest", "upload"]
    if info["bootstrap_samples"]:
        stages.append("bootstrap")
    for st in stages:
        check(st in ranges, f"[trace {tag}] no {st} range in the trace")
    t = info["timings"]
    parts = []
    for st in stages:
        ms = sum(e["dur"] for e in ranges[st]) / 1e3
        key = f"{st}_s"
        parts.append(f"{st} {ms:.6f} ms x {len(ranges[st])}"
                     + (f" (run_info {t[key] * 1e3:.6f} ms)" if key in t
                        else ""))
    m = ranges["map"][0]
    a, b = m["ts"], m["ts"] + m["dur"]
    inside = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and e["ts"] < b and e["ts"] + e["dur"] > a]
    busy = union_ms([(max(e["ts"], a), min(e["ts"] + e["dur"], b))
                     for e in inside])
    per = {}
    for e in inside:
        ms, n = per.get(e["name"], (0.0, 0))
        per[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:6]
    ingest = sum(e["dur"] for e in ranges["ingest"]) / 1e3
    upload = sum(e["dur"] for e in ranges["upload"]) / 1e3
    log(f"[trace {tag}] {len(events)} events, {len(kernels)} kernels; "
        f"ranges: {'; '.join(parts)}")
    log(f"[trace {tag} map split] map range {m['dur'] / 1e3:.6f} ms: "
        f"prefetch thread ingest {ingest:.6f} ms + upload {upload:.6f} ms "
        f"= {(ingest + upload) / (m['dur'] / 1e3):.6f} of it; device busy "
        f"{busy:.6f} ms = {busy / (m['dur'] / 1e3):.6f}; {card}")
    for name, (ms, n) in top:
        log(f"[trace {tag} map split]   {ms:10.6f} ms x {n:4d}  {name[:80]}")
    return launches


def reads_in_memory(work: Path, card: str) -> dict:
    """``[c1 reads in memory]``: ``Quantifier.quantify_reads`` on config
    1's reads, against ``quantify_files`` on their FASTQ file: the same
    mapped count and est_counts bits. Returns the launches of the
    in-memory run."""
    import numpy as np

    from seekmer_tpu_torch import EMConfig, MapConfig, PipelineConfig
    from seekmer_tpu_torch.models.quantifier import Quantifier

    index = load_index(work, "c1")
    cfg = PipelineConfig().replace(map=MapConfig(batch_size=B),
                                   em=EMConfig(rel_tol=1e-6, max_iters=2000))
    lines = (work / "c1.fq").read_text().splitlines()
    reads = lines[1::4]
    want = Quantifier(index, cfg, DEVICE).quantify_files(
        [str(work / "c1.fq")])
    reset_launches()
    t0 = time.perf_counter()
    got = Quantifier(index, cfg, DEVICE).quantify_reads(reads)
    wall = time.perf_counter() - t0
    launches = read_launches("[c1 reads in memory]",
                             (*MAIN, "em_csr", "ec_sum"))
    check((got.total_reads, got.mapped, got.unmapped)
          == (want.total_reads, want.mapped, want.unmapped)
          and np.array_equal(got.est_counts, want.est_counts),
          "config 1's reads in memory differ from the file run")
    log(f"[c1 reads in memory] {len(reads)} reads: mapped {got.mapped}, "
        f"est_counts bit-equal to quantify_files; {wall:.3f} s (map "
        f"{got.timings['map_s']:.6f} s against {want.timings['map_s']:.6f}"
        f" s from the file); {card}")
    return launches


def slice_phases(work: Path, card: str) -> dict:
    """Checkpoints, several ranks, the pack cache, traces and reads in
    memory; returns the sum of their runs' launches."""

    runs = []
    launches, plain, plain_map = checkpoint_map(work, card)
    runs.append(launches)
    runs.append(dp_phase(work, card, plain, plain_map))
    runs.append(checkpoint_em(plain_map, load_index(work, "c2"), card))
    runs.append(pack_cache_phase(work, card, plain, plain_map))
    runs.append(trace_phase(work, card, "c1", [
        str(work / "c1.fq"), "--bootstrap", "100", "--seed", "1"],
        unused=(*FAST, *STRIDED)))
    runs.append(trace_phase(work, card, "c2", [
        str(work / "c2_1.fq"), "--mates", str(work / "c2_2.fq"),
        "--sig-table-bits", "22"], unused=("em", *FAST, *STRIDED)))
    runs.append(reads_in_memory(work, card))
    keys = runs[0].keys()
    return {k: sum(r.get(k, 0) for r in runs) for k in keys}


# ---- several ranks on the one card --------------------------------------

DP_RANKS = 2
DP_DEADLINE_S = 480  # the [dp ...] phase's whole launch; then it is killed
DP_COLLECTIVE_S = 240  # a collective that waits longer raises


def timed(fn, device):
    """(seconds, result) of ``fn()``, a card synchronised at both ends."""
    import torch

    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return time.perf_counter() - t0, out


def dp_rank(rank, device, work, cfgs):
    """A rank of the ``[dp ...]`` phase, on ``device`` beside the other
    rank: the main path (``cfgs["c2"]``: config 2 paired, FLD estimated,
    ``--bootstrap 100``; launch counts from 0 just before, read just
    after), then the checks the parent prints. Rank 0 also runs the
    one-card references."""
    import torch

    from seekmer_tpu_torch import EMConfig, cli
    from seekmer_tpu_torch.em.bootstrap import batched_em
    from seekmer_tpu_torch.em.em import build_ec_table, run_em
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.fastq import batch_read_pairs_native
    from seekmer_tpu_torch.map.driver import resolve_signatures
    from seekmer_tpu_torch.map.fld import FLDEstimator
    from seekmer_tpu_torch.models.quantifier import Quantifier
    from seekmer_tpu_torch.parallel import comm
    from seekmer_tpu_torch.parallel.bootstrap_shard import (
        rank_resample, run_bootstrap_sharded)
    from seekmer_tpu_torch.parallel.data_parallel import DataParallelMapper
    from seekmer_tpu_torch.utils import checkpoint as tckpt

    out = {"rank": rank}
    index = KMerIndex.load(str(work / "c2.npz"))
    files = ([str(work / "c2_1.fq")], [str(work / "c2_2.fq")])
    cfg = cfgs["c2"]
    T = index.num_transcripts

    # [dp c2 map]: the main path
    with Spy(DataParallelMapper, "finalize") as fin:
        comm.barrier()
        reset_launches()
        wall, res = timed(lambda: Quantifier(index, cfg, device)
                          .quantify_files(*files), device)
        out["launches"] = cli.kernel_launches()
    mapper = fin.obj
    out.update(wall=wall, map=fin.calls[-1][1], timings=res.timings,
               mapped=res.mapped, est_counts=res.est_counts,
               boot=res.bootstrap_counts, fld=(res.fld_mean, res.fld_sd,
                                               res.fld_samples),
               batches=mapper._fed_batches, hist=mapper.fld_histogram(),
               own_hist=mapper.fld.hist.cpu().numpy())
    if rank == 0:  # the one card's estimator on global batches 0-3
        est = FLDEstimator(index, mapper.device_index)
        for b in batch_read_pairs_native(*files, cfg.map):
            if not est.active:
                break
            est.feed(b)
        out["one_hist"] = est.hist.cpu().numpy()
    del mapper, fin

    # [dp c2 em]: the quantifier's EM on several ranks, run_em on every
    # rank's merged table at once, against rank 0's run alone
    members, counts, _ = resolve_signatures(out["map"], index)
    out["em"] = []
    for name, emcfg in (("f32", EMConfig()),
                        ("f64", EMConfig(use_x64=True))):
        dtype = torch.float64 if emcfg.use_x64 else torch.float32
        ec = build_ec_table(members, counts, T, dtype=dtype, device=device)
        comm.barrier()
        wall, (alpha, it) = timed(lambda: run_em(ec, index.lengths, emcfg),
                                  device)
        row = dict(name=name, wall=wall, it=it, alpha=alpha.cpu().numpy())
        comm.barrier()
        if rank == 0:
            wall1, (a1, it1) = timed(
                lambda: run_em(ec, index.lengths, emcfg), device)
            row.update(wall1=wall1, it1=it1, alpha1=a1.cpu().numpy())
        out["em"].append(row)
    # an exchange alone: 200 all-reduces of 3 doubles, as the sharded
    # bootstrap's one a block
    x = torch.zeros(3, dtype=torch.float64)
    comm.barrier()
    t0 = time.perf_counter()
    for _ in range(200):
        comm.allreduce(x, "max")
    out["exchange_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    comm.barrier()

    # [dp c2 bootstrap]: each rank's replicates against batched_em on the
    # gathered count matrix
    ec = build_ec_table(members, counts, T, device=device)
    bcfg = EMConfig(bootstrap_samples=100)
    comm.barrier()
    wall, (boot, it) = timed(lambda: run_bootstrap_sharded(
        ec, index.lengths, bcfg), device)
    out["bootstrap"] = dict(wall=wall, it=it)
    if rank == 0:
        cmat = torch.cat([rank_resample(ec, bcfg, r, comm.world())
                          for r in range(comm.world())])
        wall1, (want, it1) = timed(lambda: batched_em(
            cmat, ec.ec_ids, ec.txp_ids, index.lengths, ec.num_ecs, T,
            bcfg), device)
        mass = boot.sum(dim=1).double() / cmat.sum(dim=1).double() - 1
        out["bootstrap"].update(
            wall1=wall1, it1=it1, equal=bool(torch.equal(boot, want)),
            mass=float(mass.abs().max()), shape=tuple(boot.shape))
    del ec, boot

    # [dp c2 resume]: stopped after the first save (global batches 0-1),
    # resumed; then a sidecar a step ahead, refused on both ranks
    ckpt = str(work / f"dp{comm.world()}.ckpt.npz")

    def run():
        return Quantifier(index, cfgs["c2_plain"], device).quantify_files(
            *files, checkpoint_path=ckpt, checkpoint_every=1)

    with Spy(DataParallelMapper, "save_checkpoint", crash_after=1) as saves:
        try:
            run()
            check(False, "the interrupted 2-rank run was not stopped")
        except Crash:
            pass
    with Spy(DataParallelMapper, "save_checkpoint") as saves2, \
            Spy(DataParallelMapper, "restore_checkpoint") as restore:
        wall, got = timed(run, device)
    out["resume"] = dict(
        wall=wall, est_counts=got.est_counts, mapped=got.mapped,
        fld=(got.fld_mean, got.fld_sd, got.fld_samples),
        save_s=[t for t, _ in saves.calls + saves2.calls],
        restore_s=restore.calls[0][0],
        bytes=[Path(ckpt).stat().st_size,
               Path(tckpt.host_cursor_path(ckpt, rank)).stat().st_size])
    comm.barrier()
    if rank == 1:
        cursor, total, step, fld = tckpt.load_host_cursor(ckpt, 1)
        tckpt.save_host_cursor(ckpt, 1, cursor, total, step + 1, fld)
    comm.barrier()
    t0 = time.perf_counter()
    try:
        run()
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = (str(e), time.perf_counter() - t0)

    # [dp c1 fast], [dp c1 strided]: mapped as one rank's
    index1 = KMerIndex.load(str(work / "c1.npz"))
    out["c1"] = {}
    for name in ("fast", "strided"):
        cfg1 = cfgs[f"c1_{name}"]
        comm.barrier()
        reset_launches()
        wall, r1 = timed(lambda: Quantifier(index1, cfg1, device)
                         .quantify_files([str(work / "c1.fq")]), device)
        out["c1"][name] = dict(wall=wall, mapped=r1.mapped,
                               unmapped=r1.unmapped,
                               map_s=r1.timings["map_s"],
                               launches=cli.kernel_launches())
    return out


def one_card_c2_boot(work: Path):
    """(seconds, timings) of one card's ``Quantifier`` on config 2 with
    ``--bootstrap 100``, timed as a ``[dp c2 map]`` rank times its run
    (the index loaded before), in this process."""
    import torch

    from seekmer_tpu_torch.models.quantifier import Quantifier

    index = load_index(work, "c2")
    device = torch.device(DEVICE)
    wall, res = timed(lambda: Quantifier(
        index, c2_pipeline(bootstrap_samples=100), DEVICE).quantify_files(
            [str(work / "c2_1.fq")], [str(work / "c2_2.fq")]), device)
    del index
    torch.cuda.empty_cache()
    return wall, res.timings


def dp_phase(work: Path, card: str, plain, plain_map, devices=None,
             backend: str = "gloo") -> dict:
    """``[dp ...]``: the multi-GPU path, each rank's kernels on its card,
    through ``parallel.comm.launch``: by default 2 ranks on the one card
    over gloo (NCCL refuses two ranks on one GPU); ``devices`` and
    ``backend`` put a rank on each of several cards over NCCL.
    ``plain``/``plain_map`` are the one-rank config-2 run's QuantResult
    and MapResult. Returns the launch counts of the ranks' main-path
    runs, summed."""
    import numpy as np

    from seekmer_tpu_torch import MapConfig, PipelineConfig, ShardConfig
    from seekmer_tpu_torch.parallel import comm

    if devices is None:
        devices = [DEVICE if DEVICE == "cpu" else "cuda:0"] * DP_RANKS
    n = len(devices)
    where = (f"{n} ranks on {len(set(devices))} card(s), {backend}")
    c1_runs = {name: json.loads((work / f"c1_{name}_out" / "run_info.json")
                                .read_text())
               for name in ("fast", "strided")}
    shard = ShardConfig(data_axis=n)
    cfgs = {"c2": c2_pipeline(bootstrap_samples=100).replace(shard=shard),
            "c2_plain": c2_pipeline().replace(shard=shard)}
    for name, kw in (("fast", dict(probe_sample=16)),
                     ("strided", dict(probe_stride=4))):
        cfgs[f"c1_{name}"] = PipelineConfig().replace(
            map=MapConfig(batch_size=B, **kw), shard=shard)
    one = one_card_c2_boot(work)
    t0 = time.perf_counter()
    outs = comm.launch(n, dp_rank, (work, cfgs), devices=devices,
                       backend=backend, timeout_s=DP_DEADLINE_S,
                       collective_timeout_s=DP_COLLECTIVE_S)
    wall = time.perf_counter() - t0
    r0 = outs[0]

    def each(get, fmt="{:.6f}"):
        return " / ".join(fmt.format(get(o)) for o in outs)

    def stages(t):
        return ", ".join(f"{k} {t[k + '_s']:.6f} s"
                         for k in ("map", "resolve", "em", "bootstrap"))

    # [dp c2 map]
    for o in outs:
        check(same_map(o["map"], plain_map),
              f"[dp c2 map] rank {o['rank']}'s merged MapResult differs "
              "from the one-rank run's")
        check(np.array_equal(o["hist"], r0["one_hist"]),
              "[dp c2 map] the FLD histogram summed over the ranks differs "
              "from one card's")
        check(o["fld"] == (plain.fld_mean, plain.fld_sd, plain.fld_samples),
              f"[dp c2 map] FLD estimate {o['fld']} != one rank's")
        check(np.array_equal(o["est_counts"], plain.est_counts),
              "[dp c2 map] est_counts differ from the one-rank run's bits")
    check(np.array_equal(sum(o["own_hist"] for o in outs), r0["one_hist"]),
          "[dp c2 map] the ranks' own histograms do not add up")
    m = r0["map"]
    log(f"[dp c2 map] {where}: batches {each(lambda o: o['batches'], '{}')}"
        f", mapped {m.mapped} / {m.total_reads} and {m.sigs.shape[0]} "
        f"signatures equal to one rank's, overflow {m.overflow} and "
        f"collisions {m.collisions} summed; FLD histogram summed "
        f"({int(r0['hist'][1:].sum())} pairs: "
        f"{each(lambda o: int(o['own_hist'][1:].sum()), '{}')}) equal to "
        f"one card's; est_counts bit-equal; map stage "
        f"{each(lambda o: o['timings']['map_s'])} s (one rank "
        f"{plain.timings['map_s']:.6f} s); quantify with --bootstrap 100 "
        f"{each(lambda o: o['wall'], '{:.3f}')} s (rank 0: "
        f"{stages(r0['timings'])}) against one card {one[0]:.3f} s "
        f"({stages(one[1])}); launches "
        f"{[o['launches'] for o in outs]}; {card}")

    # [dp c2 em]
    for i, row in enumerate(r0["em"]):
        rows = [o["em"][i] for o in outs]
        same = all(np.array_equal(r["alpha"], row["alpha1"])
                   and r["alpha"].dtype == row["alpha1"].dtype
                   and r["it"] == row["it1"] for r in rows)
        check(same, f"[dp c2 em] {row['name']}: {[r['it'] for r in rows]} "
              f"iterations (one card alone {row['it1']}), or other bits")
        log(f"[dp c2 em] {row['name']}, {where}: run_em on every rank's "
            f"merged table, alpha bit-equal on every rank to one card's "
            f"run alone, {row['it']} iterations; wall "
            f"{each(lambda o: o['em'][i]['wall'])} s, all ranks at once, "
            f"against one card alone {row['wall1']:.6f} s; {card}")

    # [dp c2 bootstrap]
    b = r0["bootstrap"]
    check(b["equal"] and b["mass"] < 1e-3
          and all(o["bootstrap"]["it"] == b["it1"] for o in outs),
          f"[dp c2 bootstrap] {b}")
    log(f"[dp c2 bootstrap] B 100 ({b['shape']}), {100 // n} replicates a "
        f"rank, {where}: bit-equal to one card's batched_em on the "
        f"gathered count matrix, {b['it']} iterations both; row mass max "
        f"relative error {b['mass']:.3g}; wall "
        f"{each(lambda o: o['bootstrap']['wall'])} s against one card "
        f"{b['wall1']:.6f} s; a block's exchange alone (a 3-double "
        f"all-reduce) {each(lambda o: o['exchange_ms'])} ms; {card}")

    # [dp c2 resume]
    for o in outs:
        r = o["resume"]
        check(np.array_equal(r["est_counts"], plain.est_counts)
              and r["mapped"] == plain.mapped
              and r["fld"] == (plain.fld_mean, plain.fld_sd,
                               plain.fld_samples),
              f"[dp c2 resume] rank {o['rank']}: the resumed run differs")
        check(o["refusal"] is not None,
              f"[dp c2 resume] rank {o['rank']} took a sidecar a step ahead")
    r = r0["resume"]
    log(f"[dp c2 resume] {where}: stopped after the first save (global "
        f"batches 0-{n - 1}), resumed: est_counts bit-equal to one rank's, "
        f"FLD equal; {len(r['save_s'])} saves, {min(r['save_s']):.6f}-"
        f"{max(r['save_s']):.6f} s a save (the ranks' tables gathered to "
        f"rank 0, {r['bytes'][0]} bytes, a {r['bytes'][1]}-byte sidecar a "
        f"rank); restore {r['restore_s']:.6f} s; resumed run "
        f"{r['wall']:.3f} s; rank 1's sidecar a step ahead refused on "
        f"every rank in {each(lambda o: o['refusal'][1], '{:.3f}')} s "
        f"(\"{outs[1]['refusal'][0][:60]}...\" / "
        f"\"{r0['refusal'][0][:60]}...\"); {card}")

    # [dp c1 fast], [dp c1 strided]
    need = {"fast": (*MAIN, *FAST),
            "strided": ("pack", "signature", "accumulate", *STRIDED)}
    for name in ("fast", "strided"):
        one = c1_runs[name]
        for o in outs:
            c = o["c1"][name]
            check((c["mapped"], c["unmapped"])
                  == (one["mapped"], one["unmapped"]),
                  f"[dp c1 {name}] rank {o['rank']}: mapped {c['mapped']}"
                  f" != one rank's {one['mapped']}")
        launches = {k: sum(o["c1"][name]["launches"][k] for o in outs)
                    for k in r0["c1"][name]["launches"]}
        for k in need[name]:
            check(launches[k] > 0, f"[dp c1 {name}] kernel {k} was never "
                  "launched")
        log(f"[dp c1 {name}] {where}: mapped {one['mapped']} / unmapped "
            f"{one['unmapped']} equal to one rank's; map stage "
            f"{each(lambda o: o['c1'][name]['map_s'])} s (one rank "
            f"{one['timings']['map_s']:.6f} s); launches {launches}; {card}")
    total = {k: sum(o["launches"][k] for o in outs)
             for k in r0["launches"]}
    for k in (*MAIN, "em_csr", "ec_sum"):
        check(total[k] > 0, f"[dp c2 map] kernel {k} was never launched")
    log(f"[dp] {where}: phase wall {wall:.1f} s ({n} ranks spawned, each "
        f"loading both indexes)")
    for name in ("fast", "strided"):
        for o in outs:
            for k, v in o["c1"][name]["launches"].items():
                total[k] += v
    return total


def dp_cards(work: Path, card: str, ranks) -> None:
    """``--dp-cards``: the worlds, the one-rank runs the ``[dp ...]``
    phase is held to (config 1 fast and strided ``infer``, config 2
    through the ``Quantifier``), then the phase over NCCL with a rank on
    each of n cards, for each n in ``ranks``."""
    import torch

    from seekmer_tpu_torch.map.driver import Mapper
    from seekmer_tpu_torch.models.quantifier import Quantifier

    check(torch.cuda.device_count() >= max(ranks),
          f"--dp-cards {max(ranks)} needs as many cards; this machine has "
          f"{torch.cuda.device_count()}")
    log(f"[card] x {torch.cuda.device_count()}")
    make_worlds(work)
    run_infer(work, "c1", [str(work / "c1.fq"), "--probe-sample", "16"],
              unused=("em", *STRIDED), name="c1_fast")
    run_infer(work, "c1", [str(work / "c1.fq"), "--probe-stride", "4"],
              unused=("em", "lookup", *FAST), name="c1_strided")
    index = load_index(work, "c2")
    with Spy(Mapper, "finalize") as fin:
        plain = Quantifier(index, c2_pipeline(), DEVICE).quantify_files(
            [str(work / "c2_1.fq")], [str(work / "c2_2.fq")])
    del index
    torch.cuda.empty_cache()
    for n in ranks:
        devices = [f"cuda:{r}" for r in range(n)]
        dp_phase(work, card, plain, fin.calls[-1][1], devices=devices,
                 backend="nccl")
        ps_phase(work, card, devices=devices, backend="nccl")


# ---- the prefix-sharded index ---------------------------------------------

PS_DEADLINE_S = 480  # the [ps ...] phase's whole launch; then it is killed


def ps_rank(rank, device, work, cfgs):
    """A rank of the ``[ps ...]`` phase: the main path (``cfgs["c2"]``:
    config 2 paired under the prefix-sharded index, FLD estimated,
    ``--bootstrap 100``; launch counts from 0 just before, read just
    after), then config 2 in fast mode at s = 16 and config 1 at capacity
    factor 0.3 through the mapper alone. Rank 0 also samples shard 0 for
    the FLD on one card, fed the global batches whole."""
    import torch

    from seekmer_tpu_torch import cli
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.fastq import (batch_read_pairs_native,
                                            batch_reads_native)
    from seekmer_tpu_torch.map.fld import FLDEstimator
    from seekmer_tpu_torch.models.quantifier import Quantifier
    from seekmer_tpu_torch.parallel import comm
    from seekmer_tpu_torch.parallel.prefix_shard import (PrefixShardedMapper,
                                                        capacity)

    out = {"rank": rank}
    index = KMerIndex.load(str(work / "c2.npz"))
    files = ([str(work / "c2_1.fq")], [str(work / "c2_2.fq")])
    cfg = cfgs["c2"]

    # [ps c2 map]: the main path
    with Spy(PrefixShardedMapper, "finalize") as fin, \
            Spy(PrefixShardedMapper, "__init__") as init:
        comm.barrier()
        reset_launches()
        wall, res = timed(lambda: Quantifier(index, cfg, device)
                          .quantify_files(*files), device)
        out["launches"] = cli.kernel_launches()
    mapper = fin.obj
    out.update(wall=wall, setup=init.calls[0][0], map=fin.calls[-1][1],
               timings=res.timings,
               mapped=res.mapped, est_counts=res.est_counts,
               fld=(res.fld_mean, res.fld_sd, res.fld_samples),
               batches=mapper._fed_batches, hist=mapper.fld_histogram(),
               own_hist=mapper.fld.hist.cpu().numpy(),
               rounds=mapper.extra_routing_rounds,
               shard_bytes=(mapper.sdi.table.numel()
                            + mapper.sdi.stash.numel()) * 4)
    # one all_to_all of a round's slab hi as routed_lookup sends a config-2
    # batch's (a rank's lanes at the mapper's capacity factor), R1's
    # neighbour on the routed path
    lanes = cfg.map.batch_size // mapper.sharers * 2 * (128 - index.k + 1)
    slab = torch.zeros(mapper.n_index * capacity(
        lanes, mapper.n_index, mapper.capacity_factor), dtype=torch.int32,
        device=device)
    spans = []
    for _ in range(5):
        comm.barrier()
        spans.append(timed(lambda: comm.all_to_all(slab, mapper.group),
                           device)[0])
    out.update(a2a_ms=sorted(spans)[2] * 1e3, a2a_bytes=slab.numel() * 4)
    del slab
    if rank == 0:
        table0, tid0, pos0 = mapper._fld_shard0
        est = FLDEstimator.for_prefix_shard0(
            index, torch.from_numpy(table0).to(device), tid0, pos0,
            mapper.n_index)
        for b in batch_read_pairs_native(*files, cfg.map):
            if not est.active:
                break
            est.feed(b)
        out["one_hist"] = est.hist.cpu().numpy()
    del mapper, fin

    def mapped_alone(index, mcfg, batches, cf=2.0):
        comm.barrier()
        reset_launches()
        m = PrefixShardedMapper(index, mcfg, cfg.shard, device,
                                capacity_factor=cf)
        wall, r = timed(lambda: m.run(m.select(batches)), device)
        return dict(map=r, wall=wall, rounds=m.extra_routing_rounds,
                    launches=cli.kernel_launches())

    # [ps c2 fast s=16]
    out["fast"] = mapped_alone(index, cfgs["c2_fast"].map,
                               batch_read_pairs_native(*files,
                                                       cfgs["c2_fast"].map))
    # [ps c1 low-capacity]
    index1 = KMerIndex.load(str(work / "c1.npz"))
    c1 = cfgs["c1"].map
    out["c1"] = mapped_alone(index1, c1, batch_reads_native(
        [str(work / "c1.fq")], c1), cf=0.3)
    return out


def ps_references(work: Path):
    """The one-card runs the ``[ps ...]`` checks hold the ranks to, in this
    process: config 2 dense and in fast mode at s = 16, config 1 dense
    ((seconds, MapResult) each) and, given the ranks' FLD estimate,
    config 2's quantifier with that fragment length
    (``ps_est_counts``)."""
    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.io.fastq import (batch_read_pairs_native,
                                            batch_reads_native)
    from seekmer_tpu_torch.map.driver import Mapper

    dev = torch.device(DEVICE)
    out = {}
    index = load_index(work, "c2")
    for name, s in (("c2", 0), ("fast", 16)):
        cfg = MapConfig(batch_size=B, sig_table_bits=22, paired_end=True,
                        probe_sample=s)
        m = Mapper(index, cfg, DEVICE)
        out[name] = timed(lambda: m.run(batch_read_pairs_native(
            [str(work / "c2_1.fq")], [str(work / "c2_2.fq")], cfg)), dev)
        del m
    del index
    index1 = load_index(work, "c1")
    c1 = MapConfig(batch_size=B)
    m = Mapper(index1, c1, DEVICE)
    out["c1"] = timed(lambda: m.run(batch_reads_native(
        [str(work / "c1.fq")], c1)), dev)
    del m
    torch.cuda.empty_cache()
    return out


def ps_est_counts(work: Path, fld):
    """One card's config-2 quantifier with ``--bootstrap 100`` and the
    fragment length ``fld`` (mean, sd, samples) given: (seconds,
    QuantResult)."""
    import torch

    from seekmer_tpu_torch.models.quantifier import Quantifier

    index = load_index(work, "c2")
    cfg = c2_pipeline(mean_fragment_length=fld[0], fragment_length_sd=fld[1],
                      estimate_fld=False, bootstrap_samples=100)
    out = timed(lambda: Quantifier(index, cfg, DEVICE).quantify_files(
        [str(work / "c2_1.fq")], [str(work / "c2_2.fq")]),
        torch.device(DEVICE))
    del index
    torch.cuda.empty_cache()
    return out


def ps_phase(work: Path, card: str, devices=None,
             backend: str = "gloo") -> dict:
    """``[ps ...]``: the prefix-sharded index, a shard a rank, each rank's
    kernels on its card, through ``parallel.comm.launch``: by default 2
    ranks on the one card over gloo (NCCL refuses two ranks on one GPU),
    index layout (1, 2); ``devices`` and ``backend`` put a rank on each of
    several cards over NCCL, layout (1, n). Returns the launch counts of
    the ranks' runs, summed."""
    import numpy as np

    from seekmer_tpu_torch import MapConfig, PipelineConfig, ShardConfig
    from seekmer_tpu_torch.map.fld import estimate_from_hist
    from seekmer_tpu_torch.parallel import comm

    if devices is None:
        devices = [DEVICE if DEVICE == "cpu" else "cuda:0"] * DP_RANKS
    n = len(devices)
    where = (f"{n} ranks on {len(set(devices))} card(s), {backend}, index "
             f"layout (1, {n})")
    shard = ShardConfig(data_axis=1, index_axis=n, index_mode="prefix")
    cfgs = {"c2": c2_pipeline(bootstrap_samples=100).replace(shard=shard),
            "c2_fast": PipelineConfig().replace(map=MapConfig(
                batch_size=B, sig_table_bits=22, paired_end=True,
                probe_sample=16), shard=shard),
            "c1": PipelineConfig().replace(map=MapConfig(batch_size=B),
                                           shard=shard)}
    ref = ps_references(work)
    plain_map = ref["c2"][1]
    t0 = time.perf_counter()
    outs = comm.launch(n, ps_rank, (work, cfgs), devices=devices,
                       backend=backend, timeout_s=PS_DEADLINE_S,
                       collective_timeout_s=DP_COLLECTIVE_S)
    wall = time.perf_counter() - t0
    r0 = outs[0]
    one_wall, one = ps_est_counts(work, r0["fld"])

    def each(get, fmt="{:.6f}"):
        return " / ".join(fmt.format(get(o)) for o in outs)

    def stages(t):
        return ", ".join(f"{k} {t[k + '_s']:.6f} s"
                         for k in ("map", "resolve", "em", "bootstrap"))

    need = (*MAIN, *ROUTED)
    # [ps c2 map]
    want_fld = estimate_from_hist(r0["one_hist"])
    for o in outs:
        check(same_map(o["map"], plain_map),
              f"[ps c2 map] rank {o['rank']}'s merged MapResult differs "
              "from the one-rank run's")
        check(np.array_equal(o["hist"], r0["one_hist"]),
              "[ps c2 map] the shard-0 FLD histogram summed over the ranks "
              "differs from one card's")
        check(o["fld"] == want_fld, f"[ps c2 map] FLD estimate {o['fld']} "
              f"!= one card's shard-0 estimate {want_fld}")
        check(np.array_equal(o["est_counts"], one.est_counts),
              "[ps c2 map] est_counts differ from one card's bits at the "
              "same fragment length")
        for k in need:
            check(o["launches"][k] > 0, f"[ps c2 map] rank {o['rank']}: "
                  f"kernel {k} was never launched")
    check(np.array_equal(sum(o["own_hist"] for o in outs), r0["one_hist"]),
          "[ps c2 map] the ranks' own histograms do not add up")
    m = r0["map"]
    lanes = B // n * 2 * (128 - 25 + 1)
    K = int(np.ceil(lanes / n * 2.0))
    log(f"[ps c2 map] {where}: batches {each(lambda o: o['batches'], '{}')}"
        f", mapped {m.mapped} / {m.total_reads} and {m.sigs.shape[0]} "
        f"signatures equal to one rank's, extra routing rounds "
        f"{r0['rounds']}; shard-0 FLD histogram summed "
        f"({int(r0['hist'][1:].sum())} pairs: "
        f"{each(lambda o: int(o['own_hist'][1:].sum()), '{}')}) equal to one "
        f"card's shard-0 estimator, estimate {r0['fld']}; est_counts "
        f"bit-equal to one card's quantifier at that fragment length; a "
        f"rank's shard {r0['shard_bytes']} bytes; a "
        f"batch routes {lanes} lanes a rank, K {K}, each all_to_all out "
        f"moves {n * K * 4} bytes a rank (hi, then lo), the one back as "
        f"many; one all_to_all of a round's slab hi ({r0['a2a_bytes']} "
        f"bytes a rank), host clock, median of 5: "
        f"{each(lambda o: o['a2a_ms'])} ms; map stage "
        f"{each(lambda o: o['timings']['map_s'])} s (one "
        f"card {one.timings['map_s']:.6f} s); quantify with --bootstrap 100 "
        f"{each(lambda o: o['wall'], '{:.3f}')} s (the shards' build and "
        f"upload {each(lambda o: o['setup'], '{:.3f}')} s of it; rank 0: "
        f"{stages(r0['timings'])}) against one card {one_wall:.3f} s "
        f"({stages(one.timings)}); launches "
        f"{[o['launches'] for o in outs]}; {card}")

    # [ps c2 fast s=16]
    one_wall, want = ref["fast"]
    for o in outs:
        check(same_map(o["fast"]["map"], want),
              f"[ps c2 fast s=16] rank {o['rank']}: the MapResult differs "
              "from one card's fast mode")
        for k in ("pack", "lookup", "signature", "merge", "accumulate",
                  *ROUTED):
            check(o["fast"]["launches"][k] > 0, f"[ps c2 fast s=16] rank "
                  f"{o['rank']}: kernel {k} was never launched")
        check(o["fast"]["launches"]["sample"] == 0,
              "[ps c2 fast s=16] K5 launched under the sharded index")
    log(f"[ps c2 fast s=16] {where}: mapped {want.mapped} / "
        f"{want.total_reads} and {want.sigs.shape[0]} signatures equal to "
        f"one card's fast mode; map {each(lambda o: o['fast']['wall'])} s "
        f"(one card {one_wall:.6f} s); launches "
        f"{[o['fast']['launches'] for o in outs]}; {card}")

    # [ps c1 low-capacity]
    one_wall, want = ref["c1"]
    for o in outs:
        check(same_map(o["c1"]["map"], want),
              f"[ps c1 low-capacity] rank {o['rank']}: the MapResult "
              "differs from one card's")
        check(o["c1"]["rounds"] > 0, "[ps c1 low-capacity] capacity "
              "factor 0.3 took no extra routing round")
    log(f"[ps c1 low-capacity] {where}, capacity factor 0.3: extra routing "
        f"rounds {r0['c1']['rounds']}, mapped {want.mapped} / "
        f"{want.total_reads} and {want.sigs.shape[0]} signatures equal to "
        f"one card's; map {each(lambda o: o['c1']['wall'])} s (one card "
        f"{one_wall:.6f} s); {card}")
    log(f"[ps] {where}: phase wall {wall:.1f} s ({n} ranks spawned, each "
        f"loading both indexes and building the shards)")
    total = {k: sum(o["launches"][k] for o in outs)
             for k in r0["launches"]}
    for name in ("fast", "c1"):
        for o in outs:
            for k, v in o[name]["launches"].items():
                total[k] += v
    return total


KERNELS = [
    ("K1", "pack", "seekmer_tpu_torch/csrc/pack.cu",
     "seekmer_tpu/ops/pack_pallas.py:26"),
    ("K2", "lookup", "seekmer_tpu_torch/csrc/probe.cu",
     "seekmer_tpu/ops/probe_pallas.py:45"),
    ("K3", "signature", "seekmer_tpu_torch/csrc/sig.cu",
     "seekmer_tpu/ops/sig_pallas.py:56"),
    ("K4", "em", "seekmer_tpu_torch/csrc/em.cu",
     "seekmer_tpu/ops/em_pallas.py:42"),
    ("A1", "accumulate", "seekmer_tpu_torch/csrc/accumulate.cu",
     "seekmer_tpu/map/signature.py:127"),
    ("K5", "sample", "seekmer_tpu_torch/csrc/sample.cu",
     "seekmer_tpu/ops/probe.py:339"),
    ("K6", "merge", "seekmer_tpu_torch/csrc/merge.cu",
     "seekmer_tpu/ops/probe.py:481"),
    ("A3", "em_csr", "seekmer_tpu_torch/csrc/em_csr.cu",
     "seekmer_tpu/em/bootstrap.py:86"),
    ("K7", "strided", "seekmer_tpu_torch/csrc/strided.cu",
     "seekmer_tpu/ops/probe.py:493"),
    ("A4", "ec_sum", "seekmer_tpu_torch/csrc/em_csr.cu",
     "seekmer_tpu/em/em.py:441"),
    ("R1", "route", "seekmer_tpu_torch/csrc/route.cu",
     "seekmer_tpu/parallel/prefix_shard.py:205"),
    ("R2", "unroute", "seekmer_tpu_torch/csrc/route.cu",
     "seekmer_tpu/parallel/prefix_shard.py:247"),
]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep-inputs", metavar="PATH",
                    help="write K3's, fast mode's and R1's inputs of the "
                    "config-2 batch there and A4's to PATH.a4.pt, for "
                    "python -m seekmer_tpu_torch.utils.kernel_ab, and config "
                    "2's EC table to PATH.c2_ec.npz")
    ap.add_argument("--dp-cards", metavar="N[,N...]",
                    help="run only the [dp ...] phase and the one-rank runs "
                    "it is held to, over NCCL with a rank on each of N "
                    "cards, for each N")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (REPO / "seekmer_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"[card] {card}")
    from seekmer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build()
    log(f"[build] {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.log_path().read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"[build] {line.strip()}")

    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO / "build"))
    if args.dp_cards:
        try:
            dp_cards(work, card, [int(n) for n in args.dp_cards.split(",")])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(card)
        print(json.dumps({"dp_cards_ok": True, "ranks": args.dp_cards,
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}))
        return 0
    try:
        *batches, injected = make_worlds(work)
        timing, steps = compare_kernels(work, batches, args.keep_inputs)
        timing["K4"] = compare_em_kernel(work)
        launches, infos, c1_raw = end_to_end(work)
        fused = fuse_check(work, injected)
        launches = {k: launches[k] + fused[k] for k in launches}
        more = slice_phases(work, card)
        launches = {k: launches[k] + more[k] for k in launches}
        timing.update(profile_stages(work, args.keep_inputs))
        more = baseline_phase(work, batches, card, steps, infos, c1_raw)
        launches = {k: launches[k] + more[k] for k in launches}
        # the prefix-sharded index last: its launches are R1's and R2's
        more = ps_phase(work, card)
        launches = {k: launches[k] + more[k] for k in launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for kid, name, src, replaces in KERNELS:
        kernels.append({"name": f"{kid} {name}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": launches[name], **timing[kid]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
