#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seekmer_tpu_torch) once on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero:

1. print the card's name and power limit, build the five kernels from
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
   config-1 batch (a table that mostly sits in L2); K4 dense EM at the
   config-1 bootstrap shapes (the world's ECs, 100 resampled replicates)
   and at R = 1, to convergence and for the same
   fixed iteration count (with a TF32 control of the plain version that
   must miss the bound, and a rerun that must give the same bits), then
   on two systems at the dense gate's edge, E-deep and T-deep, that walk
   their depth in chunks;
4. run ``infer --device cuda`` of the port's CLI on both worlds with every
   kernel's launch count set to 0 just before and read just after:
   config 1 with ``--bootstrap 100`` (the dense route, through K4; the
   mapped count and the point estimate checked against the port's plain
   path on the CPU with float64 EM, which the CPU tests hold against the
   JAX package and its float64 oracle),
   config 2 paired with no fragment flags (the fragment-length estimate
   checked against the simulated one) and ``--bootstrap 100`` (the
   batched CSR route); check the outputs and print the stage rates;
5. trace the map stage (``Mapper.run`` fed as ``infer`` feeds it), a
   fixed 480-iteration EM and a fixed 480-iteration 100-replicate
   bootstrap on both worlds with ``torch.profiler``; print each stage's
   wall time untraced and traced, its device busy time, and the device
   time per kernel or copy. On config 2, before its bootstrap is traced,
   the card's batched CSR EM is held against the same call on the CPU.

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


def compare_kernels(work: Path, batches):
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
    from seekmer_tpu_torch.ops import accumulate_cuda, pack_cuda, sig_cuda

    dev = torch.device(DEVICE)
    L = 128  # 100 bp reads sit in the 128 length bucket
    out = {}

    # K2 on config 1 first: its table leaves the card before config 2's
    index = KMerIndex.load(str(work / "c1.npz"))
    di = DeviceIndex.from_host(index, dev)
    c1_lanes = pack_cuda.pack_canonical_2bit(
        *upload_mate(batches[0], L, dev), L, index.k)
    c1 = check_lookup("config 1", index, di, *c1_lanes)[0]
    del di, c1_lanes

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
    got = sig_cuda.read_signatures(ecs, valid, C)
    ref = sig_cuda.plain(ecs, valid, C)
    err = max(max_abs_diff(g, r) for g, r in zip(got, ref))
    out["K3"] = record(
        err, cuda_ms(lambda: sig_cuda.read_signatures(ecs, valid, C), 50),
        cuda_ms(lambda: sig_cuda.plain(ecs, valid, C), 10),
        nbytes(ecs, valid, *got) / HBM_BYTES_S, "bytes")
    log(f"[K3 signature] [{B}, {ecs.shape[1]}] C={C}: max_abs_err {err}, "
        f"kernel {out['K3']['ms']:.4f} ms, plain {out['K3']['plain_ms']:.4f} "
        f"ms, bound {out['K3']['bound_ms']:.4f} ms")

    sig, mapped = got
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
    out["A1"] = record(
        err,
        cuda_ms_each(fresh, lambda t: accumulate_cuda.fold_batch(
            t, sig, mapped, weights=weights), 20),
        cuda_ms_each(fresh, lambda t: accumulate_cuda.plain(
            t, sig, mapped, weights=weights), 5),
        a1_bytes / HBM_BYTES_S, "bytes")
    # steady state: the batch's signatures are already in both tables, so
    # every lane takes the matching path and none claims a slot
    steady = (cuda_ms(lambda: accumulate_cuda.fold_batch(
                  tables[0], sig, mapped, weights=weights), 20),
              cuda_ms(lambda: accumulate_cuda.plain(
                  tables[1], sig, mapped, weights=weights), 5))
    log(f"[A1 accumulate] {B} reads ({multi} multi-EC) at sig_table_bits=22: "
        f"{mk.sigs.shape[0]} merged signatures, overflow {mk.overflow}, "
        f"collisions {mk.collisions}; max_abs_err {err}; empty table "
        f"(claims): kernel {out['A1']['ms']:.4f} ms, plain "
        f"{out['A1']['plain_ms']:.4f} ms, bound {out['A1']['bound_ms']:.4f} "
        f"ms; steady state (matching path only): kernel "
        f"{steady[0]:.4f} ms, plain {steady[1]:.4f} ms")
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
    from seekmer_tpu_torch.ops import (accumulate_cuda, em_cuda, pack_cuda,
                                       probe_cuda, sig_cuda)

    for fn in (pack_cuda.pack_canonical_2bit, probe_cuda.lookup_ecs_aux,
               sig_cuda.read_signatures, accumulate_cuda.fold_batch,
               em_cuda.em_fixed_point):
        fn.launches = 0


def run_infer(work: Path, tag: str, argv, unused=()):
    """Run the CLI's infer; every kernel but those in ``unused`` must have
    launched during it, and those in ``unused`` must not have."""
    from seekmer_tpu_torch import cli

    out = work / f"{tag}_out"
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["infer", str(work / f"{tag}.npz"), str(out), *argv,
                   "--device", DEVICE])
    wall = time.perf_counter() - t0
    launches = cli.kernel_launches()
    check(rc == 0, f"{tag} infer exit {rc}")
    info = json.loads((out / "run_info.json").read_text())
    t = info["timings"]
    log(f"[{tag} e2e] mapped {info['mapped']} / {info['total_reads']}, "
        f"EM iterations {info['em_iterations']}, map stage "
        f"{t['reads_per_s']:.0f} reads/s ({t['map_s']:.3f} s), EM "
        f"{t['em_iterations_per_s']:.1f} it/s ({t['em_s']:.3f} s), resolve "
        f"{t['resolve_s']:.3f} s, quantifier {t['wall_s']:.3f} s, CLI wall "
        f"{wall:.1f} s, kernel launches {launches}")
    for name, n in launches.items():
        if name in unused:
            check(n == 0, f"{tag}: kernel {name} launched {n} times")
        else:
            check(n > 0, f"{tag}: kernel {name} was never launched")
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

    from seekmer_tpu_torch import EMConfig
    from seekmer_tpu_torch.index.store import KMerIndex
    from seekmer_tpu_torch.io.writer import read_abundance

    out, info, l1 = run_infer(work, "c1", [
        str(work / "c1.fq"), "--em-tolerance", "1e-6", "--em-max-iters",
        "2000", "--bootstrap", "100", "--seed", "1"])
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
        "--sig-table-bits", "22", "--bootstrap", "100"], unused=("em",))
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
    return {k: l1[k] + l2[k] for k in l1}


def cpu_reference(work: Path, index, em_cfg) -> dict:
    """The config-1 run on the CPU through the port's plain versions (which
    the CPU tests hold against the JAX package and its float64 oracle):
    mapped and unmapped reads, the ECs, and float64 EM to the TPM."""
    import dataclasses

    import torch

    from seekmer_tpu_torch import MapConfig
    from seekmer_tpu_torch.em.em import build_ec_table, run_em, tpm_from_alpha
    from seekmer_tpu_torch.io.fastq import batch_reads_native
    from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
    from seekmer_tpu_torch.utils.prefetch import device_put_batches

    cfg = MapConfig(batch_size=B)
    result = Mapper(index, cfg, device="cpu").run(device_put_batches(
        batch_reads_native([str(work / "c1.fq")], cfg), "cpu"))
    # as the Quantifier counts them: reads whose signature resolves to no
    # transcript are dropped from the mapped
    members, counts, dropped = resolve_signatures(result, index)
    x64 = dataclasses.replace(em_cfg, use_x64=True)
    ec = build_ec_table(members, counts, index.num_transcripts,
                        dtype=torch.float64, device="cpu")
    alpha, _ = run_em(ec, index.lengths, x64)
    return {"mapped": result.mapped - dropped,
            "unmapped": result.total_reads - result.mapped + dropped,
            "members": members, "counts": counts,
            "tpm": tpm_from_alpha(alpha, index.lengths, x64).numpy()}


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


def profile_stages(work: Path) -> None:
    """Trace the map stage, a fixed 480-iteration EM and a fixed
    480-iteration 100-replicate bootstrap on both worlds; on the world that
    takes the batched CSR bootstrap route, hold that route on the card
    against the CPU first."""
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

        def map_run(trace):
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
        members, counts, _ = resolve_signatures(result, index)
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
]


def main() -> int:
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
        timing = compare_kernels(work, make_worlds(work))
        timing["K4"] = compare_em_kernel(work)
        launches = end_to_end(work)
        profile_stages(work)
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
