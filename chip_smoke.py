#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seekmer_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py [--keep-inputs PATH]

(``--keep-inputs`` also writes K3's inputs of the config-2 batch to PATH,
for ``python -m seekmer_tpu_torch.utils.kernel_ab``, and config 2's EC
table to PATH.c2_ec.npz, for ``python -m tests.test_torch_bootstrap``.)

Phases; any failure exits non-zero:

1. print the card's name and power limit, build the seven kernels from
   ``seekmer_tpu_torch/csrc`` with nvcc (sm_90a, one nvcc per source);
2. make two worlds from a seed and index them through the port's CLI: the
   config-1 world (1000 random transcripts, 4 x 65,536 single-end 100 bp
   reads) and the config-2 GENCODE-scale isoform world (20,000 genes,
   4 x 65,536 read pairs of 100 bp, fragments 200 +- 20,
   sig_table_bits=22);
3. hold each kernel against its plain PyTorch version on the card and time
   both with CUDA events, beside the least time the card could take for
   the same work (bytes over 3.35 TB/s, or FP32 operations over 67
   TFLOP/s; for K4 the operations on M's nonzeros): K1 pack (one mate,
   and both mates into one output), K2 lookup, K3 signature and A1
   accumulate at the shapes of one paired config-2 batch, K2 also on one
   config-1 batch (a table that mostly sits in L2); K3 also on the rows of
   ``tests/synthetic_signatures.py`` (both of its paths), with the
   run-head histogram of both batches; A1 also on a table pre-seeded with
   a colliding key, timed as claim alone and claim plus audit, empty
   table and steady state, beside an empty launch of its grid and its
   host enqueue (K3's and A1's device times with the card kept busy while
   the host enqueues, ``utils/kernel_ab.py``); K4 dense EM at the
   config-1 bootstrap shapes (the world's ECs, 100 resampled replicates)
   and at R = 1, to convergence and for the same
   fixed iteration count (with a TF32 control of the plain version that
   must miss the bound, and a rerun that must give the same bits), then
   on two systems at the dense gate's edge, E-deep and T-deep, that walk
   their depth in chunks; fast mode's K5 (sample + probe + classify) and
   K6 (merge) on the config-2 batch at strides 16 and 8 and on the
   config-1 batch at 16, with the resolved-read and fallback-unit
   fractions and every fast signature checked to equal, or be a non-empty
   subset of, the dense one; the device map step on the pre-uploaded
   config-2 batch dense and fast (``[map step]``, ``[map step fast
   s=16]``, ``[map step fast s=8]``), the fast one's table held against
   the plain route's on the same card tensors;
4. run ``infer --device cuda`` of the port's CLI on both worlds with every
   kernel's launch count set to 0 just before and read just after:
   config 1 with ``--bootstrap 100`` (the dense route, through K4; the
   mapped count and the point estimate checked against the port's plain
   path on the CPU with float64 EM, which the CPU tests hold against the
   JAX package and its float64 oracle),
   config 2 paired with no fragment flags (the fragment-length estimate
   checked against the simulated one) and ``--bootstrap 100`` (the
   batched CSR route); then ``infer --probe-sample 16`` on both (fast
   mode: config 1's mapped and unmapped counts checked against the port's
   plain fast path on the CPU; config 2 paired with the FLD estimated and
   its mapped count beside the dense run's); check the outputs and print
   the stage rates;
5. trace the map stage (``Mapper.run`` fed as ``infer`` feeds it, dense
   and then fast at s = 16), a fixed 480-iteration EM and a fixed
   480-iteration 100-replicate bootstrap on both worlds with
   ``torch.profiler``; print each stage's wall time untraced and traced,
   its device busy time, and the device time per kernel or copy. On
   config 2, before its bootstrap is traced, the card's batched CSR EM is
   held against the same call on the CPU.

The last three lines are the card's name and power limit, the JSON line of
kernel results, and ``{"ok": true, "device": {...}}``. JAX and the JAX
package ``seekmer_tpu`` are blocked for the whole run: the port must not
need them. Float32 products run in full FP32 (TF32 off) for the plain
versions.
"""

from __future__ import annotations

import dataclasses
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
DEVICE = "cuda"
# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


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
    c1, c2, _ = simulate_packed_pairs(rng, seqs, BATCHES, B, READ_LEN,
                                      mean_frag=200.0, sd_frag=20.0)
    for name, codes in (("c2_1.fq", c1), ("c2_2.fq", c2)):
        write_fastq(str(work / name),
                    reads_from_codes(codes.reshape(-1, READ_LEN)))
    batch2 = (c1[0], c2[0])
    t_sim = time.perf_counter() - t0
    t0 = time.perf_counter()
    check(cli.main(["index", str(work / "c2.fa"), str(work / "c2.npz")]) == 0,
          "config-2 index build")
    log(f"[setup] config-2 world: {len(seqs)} transcripts from {C2_GENES} "
        f"genes, "
        f"{BATCHES * B} pairs; simulate {t_sim:.1f} s, index build + save "
        f"{time.perf_counter() - t0:.1f} s")
    return batch1, batch2


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
    from seekmer_tpu_torch.ops import (fast_cuda, pack_cuda, probe,
                                       probe_cuda, sig_cuda)
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
    for name, r, extra in (
            ("K5", k5, f"{hs.numel()} valid sampled lanes, {rows} distinct "
                       f"home rows, {nkeys} distinct keys found"),
            ("K6", k6, f"{nu} unit rows")):
        log(f"[{name} {tag} s={stride}] max_abs_err {r['max_abs_err']}, "
            f"kernel {r['ms']:.6f} ms (device time; back to back "
            f"{times[name][0]:.6f} ms, host enqueue {times[name][1]:.3f} "
            f"us), plain {r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} "
            f"ms (share {r['bound_ms'] / r['ms']:.6f}); {extra}")
    return k5, k6


def compare_kernels(work: Path, batches, keep_inputs=None):
    """Each kernel against its plain version at one paired config-2 batch's
    shapes, with the bytes each must move at the least (each input read
    once, each output written once; for the table kernels, what this
    batch needs of the table); K2 also on one config-1 batch, whose table
    mostly sits in L2. No single PyTorch call computes any of these
    functions, so none has a library time. Returns {name: record}."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.index.store import KMerIndex
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
    index = KMerIndex.load(str(work / "c1.npz"))
    di = DeviceIndex.from_host(index, dev)
    c1_lanes = pack_cuda.pack_canonical_2bit(
        *upload_mate(batches[0], L, dev), L, index.k)
    c1, c1_got = check_lookup("config 1", index, di, *c1_lanes)
    log_heads("config 1", c1_got[0], c1_lanes[2])
    check_fast("config 1", di, [upload_mate(batches[0], L, dev)], L, 16,
               sig_cuda.read_signatures(c1_got[0], c1_lanes[2], 16))
    del di, c1_lanes, c1_got

    index = KMerIndex.load(str(work / "c2.npz"))
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
    C = 16
    if keep_inputs:
        torch.save({"ecs": ecs.cpu(), "valid": valid.cpu(), "max_ecs": C,
                    "num_ecs": index.num_ecs}, keep_inputs)
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

    sig, mapped = got
    out["K5"], out["K6"] = check_fast("config 2", di, mates, L, 16, got)
    check_fast("config 2", di, mates, L, 8, got)
    weights = torch.ones(B, dtype=torch.int32, device=dev)
    tables = []
    for fold in (accumulate_cuda.fold_batch, accumulate_cuda.plain):
        t = make_sig_table(22, C, num_ecs=index.num_ecs, device=dev)
        fold(t, sig, mapped, weights=weights)
        tables.append(t)
    merged = []
    for t in tables:
        s, c = table_to_host(t)
        merged.append(merge_sig_rows(s, c, B, int(t.overflow),
                                     int(t.collisions)))
    mk, mp = merged
    check(np.array_equal(mk.sigs, mp.sigs), "A1 merged signatures differ")
    err = int(np.abs(mk.sig_counts - mp.sig_counts).max(initial=0))
    err = max(err, abs(mk.overflow - mp.overflow),
              abs(mk.collisions - mp.collisions))
    keys = [np.sort(t.key.view(torch.int64).cpu().numpy().ravel())
            for t in tables]
    check(np.array_equal(*keys), "A1 fingerprint keys differ")
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
        f"collisions {mk.collisions}; max_abs_err {err} (this batch and a "
        f"pre-seeded colliding table); bound {out['A1']['bound_ms']:.6f} ms")
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
        log(f"[map step fast s={stride}] one paired batch on the card: "
            f"{fast_ms:.6f} ms (the unit count's readback included), "
            f"{B / fast_ms * 1e3:.0f} pairs/s; dense {step_ms:.6f} ms")
    fcfg = dataclasses.replace(cfg, probe_sample=16)
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
    return out


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
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.fastq import batch_reads_native
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.ops import em_cuda, em_dense
    from seekmer_tpu_torch.utils.prefetch import device_put_batches

    dev = torch.device(DEVICE)
    index = KMerIndex.load(str(work / "c1.npz"))
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


def compare_batched_em(ec, lengths):
    """The card's batched CSR EM (the config-2 bootstrap route) against the
    same call on CPU tensors: 4 replicates resampled on the card with a
    fixed generator, a fixed 480 iterations on both sides. The mass of each
    group of transcripts with identical EC membership must agree within
    1e-3 relative + 1e-2 reads: the two differ by float32 rounding in
    another order (``index_add_`` adds with atomics on the card), while a
    replicate mixed with another, or a bad resample row, moves groups by
    whole reads."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.em.bootstrap import batched_em, resample_counts

    gen = torch.Generator(device=ec.counts.device)
    gen.manual_seed(SEED)
    cmat = resample_counts(ec.counts, 4, gen)
    cfg = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480)
    walls, outs = [], []
    for dev in (ec.counts.device, torch.device("cpu")):
        t0 = time.perf_counter()
        alpha, it = batched_em(cmat.to(dev), ec.ec_ids.to(dev),
                               ec.txp_ids.to(dev), lengths, ec.num_ecs,
                               ec.num_transcripts, cfg)
        outs.append(alpha.cpu().numpy().astype(np.float64))
        walls.append(time.perf_counter() - t0)
        check(it == 480, f"batched EM on {dev}: {it} iterations")
    # group of a transcript: a random 64-bit key per EC, summed over its
    # ECs (wrapping), so equal membership gives equal keys
    ec_ids, txp = ec.ec_ids.cpu().numpy(), ec.txp_ids.cpu().numpy()
    key = np.zeros(ec.num_transcripts, np.uint64)
    np.add.at(key, txp, np.random.default_rng(SEED).integers(
        0, 2**64, size=ec.num_ecs, dtype=np.uint64)[ec_ids])
    g = np.unique(key, return_inverse=True)[1]
    got, want = ([np.bincount(g, weights=a) for a in o] for o in outs)
    got, want = np.stack(got), np.stack(want)
    err = float(np.abs(got - want).max())
    bad = float((np.abs(got - want) - 1e-3 * np.abs(want)).max())
    apart = float(np.abs(want[1:] - want[:-1]).max())
    check(bool(np.isfinite(got).all()) and bad <= 1e-2 and apart > 1.0,
          f"batched EM, card against CPU: group masses disagree by {err} "
          f"reads (replicates apart by {apart})")
    log(f"[batched EM] {cmat.shape[0]} replicates, nnz {ec.ec_ids.numel()}, "
        f"{ec.num_ecs} ECs, {g.max() + 1} membership groups, 480 iterations: "
        f"card against CPU max abs group-mass error {err:.6g} reads (bound "
        f"1e-3 relative + 1e-2), replicates apart by up to {apart:.6g}; "
        f"card {walls[0]:.3f} s, CPU {walls[1]:.3f} s")


def reset_launches():
    from seekmer_tpu_torch.ops import (accumulate_cuda, em_cuda, fast_cuda,
                                       pack_cuda, probe_cuda, sig_cuda)

    for fn in (pack_cuda.pack_canonical_2bit, probe_cuda.lookup_ecs_aux,
               sig_cuda.read_signatures, accumulate_cuda.fold_batch,
               em_cuda.em_fixed_point, fast_cuda.sample_classify,
               fast_cuda.merge_staging):
        fn.launches = 0


DENSE_ONLY = ("sample", "merge")  # fast mode's kernels


def run_infer(work: Path, tag: str, argv, unused=(), name=None):
    """Run the CLI's infer on world ``tag`` into ``<name>_out``; every
    kernel but those in ``unused`` must have launched during it, and those
    in ``unused`` must not have."""
    from seekmer_tpu_torch import cli

    name = name or tag
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
    it against the expected one)."""
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
        f"{'dense (K4)' if k4 else 'batched CSR'} (K4 launches {k4}), "
        f"{int(t['bootstrap_iterations'])} "
        f"iterations, stage wall {t['bootstrap_s']:.6f} s; row mass vs "
        f"mapped {info['mapped']}: max relative error {err:.3g}")


def end_to_end(work: Path):
    import numpy as np

    from seekmer_tpu_torch import EMConfig, MapConfig
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.writer import read_abundance

    out, info, l1 = run_infer(work, "c1", [
        str(work / "c1.fq"), "--em-tolerance", "1e-6", "--em-max-iters",
        "2000", "--bootstrap", "100", "--seed", "1"], unused=DENSE_ONLY)
    index = KMerIndex.load(str(work / "c1.npz"))
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
        unused=("em", *DENSE_ONLY))
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
                             unused=("em",), name="c1_fast")
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
        "--sig-table-bits", "22", "--probe-sample", "16"], unused=("em",),
        name="c2_fast")
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
    return {k: l1[k] + l2[k] + l3[k] + l4[k] for k in l1}


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


def cpu_map(work: Path, index, cfg) -> dict:
    """The config-1 reads mapped under ``cfg`` on the CPU through the port's
    plain versions: mapped and unmapped counted as the Quantifier counts
    them (reads whose signature resolves to no transcript are dropped from
    the mapped), and the resolved ECs."""
    from seekmer_tpu_torch.io.fastq import batch_reads_native
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.prefetch import device_put_batches

    result = Mapper(index, cfg, device="cpu").run(device_put_batches(
        batch_reads_native([str(work / "c1.fq")], cfg), "cpu"))
    members, counts, dropped = resolve_signatures(result, index)
    return {"mapped": result.mapped - dropped,
            "unmapped": result.total_reads - result.mapped + dropped,
            "members": members, "counts": counts}


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


def profile_stages(work: Path, keep_inputs=None) -> None:
    """Trace the map stage (dense, then fast at s = 16), a fixed
    480-iteration EM and a fixed 480-iteration 100-replicate bootstrap on
    both worlds; on the world that
    takes the batched CSR bootstrap route, hold that route on the card
    against the CPU first. With ``keep_inputs``, write config 2's EC table
    to ``keep_inputs``.c2_ec.npz."""
    import numpy as np
    import torch

    from seekmer_tpu_torch import EMConfig, MapConfig
    from seekmer_tpu_torch.em.bootstrap import run_bootstrap
    from seekmer_tpu_torch.em.em import build_ec_table, run_em, use_dense
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.fastq import (batch_read_pairs_native,
                                            batch_reads_native)
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.prefetch import device_put_batches, prefetch

    dev = torch.device(DEVICE)
    fixed = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480)
    boot = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480,
                    bootstrap_samples=100, bootstrap_seed=1)
    for tag, paired, bits in (("c1", False, 20), ("c2", True, 22)):
        index = KMerIndex.load(str(work / f"{tag}.npz"))
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
        members, counts, _ = resolve_signatures(result, index)
        if keep_inputs and paired:
            np.savez(f"{keep_inputs}.c2_ec.npz", counts=counts,
                     lengths=index.lengths, sizes=[m.size for m in members],
                     members=np.concatenate(members))
        ec = build_ec_table(members, counts, index.num_transcripts,
                            device=dev)
        log(f"[profile {tag} em] nnz {ec.ec_ids.numel()}, {ec.num_ecs} ECs")
        report_stage(f"{tag} em", lambda trace: traced(lambda: (
            run_em(ec, index.lengths, fixed)[0].sum().item()), trace))
        dense = use_dense(ec, boot, 100)
        log(f"[profile {tag} bootstrap] 100 replicates, 480 iterations, "
            f"{'dense (K4)' if dense else 'batched CSR'} route")
        if not dense:
            compare_batched_em(ec, index.lengths)
        report_stage(f"{tag} bootstrap", lambda trace: traced(lambda: (
            run_bootstrap(ec, index.lengths, boot)[0].sum().item()), trace))


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
]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keep-inputs", metavar="PATH",
                    help="write K3's inputs of the config-2 batch there, for "
                    "python -m seekmer_tpu_torch.utils.kernel_ab, and config "
                    "2's EC table to PATH.c2_ec.npz")
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
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            log(f"[build] {line.strip()}")

    (REPO / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_", dir=REPO / "build"))
    try:
        timing = compare_kernels(work, make_worlds(work), args.keep_inputs)
        timing["K4"] = compare_em_kernel(work)
        launches = end_to_end(work)
        profile_stages(work, args.keep_inputs)
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
