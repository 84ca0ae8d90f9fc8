"""Command-line interface of the port: ``index`` (the host index build,
``_add_index`` and ``cmd_index`` copied from ``seekmer_tpu/cli.py``; the
file loads in either package) and ``infer`` on one device, ``--device
cuda`` by default.

``infer`` estimates the fragment-length distribution of paired runs unless
``--fragment-length`` or ``--fragment-sd`` is given, runs ``--bootstrap``
replicates, and maps in fast mode with ``--probe-sample N`` (N >= 2). It
parses every ``infer`` flag of the JAX CLI:

- ``--sample-fallback`` (validated, then ignored: the port re-probes every
  fallback unit in one pass) and ``--io-workers`` go into ``MapConfig``;
- ``--probe-chunks``, ``--pack-backend``, ``--probe-backend``,
  ``--sig-backend`` and ``--no-h2d-pack`` go into ``MapConfig`` too, whose
  fields for them the port ignores (``config.py``); ``--checkpoint-every``
  is accepted and means nothing without ``--checkpoint``;
- the features the port does not have yet (``--checkpoint``,
  ``--pack-cache``, ``--probe-stride`` > 1, ``--trace-dir``, sharding,
  ``--distributed``) are refused with an error naming their ROADMAP.md
  item, as ``fuse`` is.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np


class NotPorted(SystemExit):
    """A requested feature is not in the port yet (exit status 2)."""

    def __init__(self, what: str, item: str):
        super().__init__(f"seekmer_tpu_torch: {what} is not ported yet "
                         f"(ROADMAP.md, still to port: {item})")


def _add_index(sub):
    p = sub.add_parser("index",
                       help="build a k-mer index from a transcriptome")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("fasta", help="transcriptome FASTA (.fa/.fa.gz)")
    p.add_argument("output", help="output index file (.npz)")
    p.add_argument("--gtf", default=None, help="GTF for transcript->gene map")
    p.add_argument("--kmer-length", type=int, default=25)
    p.add_argument("--load-factor", type=float, default=0.5)
    return p


def cmd_index(args) -> int:
    from .config import IndexConfig
    from .index.build import build_index

    cfg = IndexConfig(k=args.kmer_length, load_factor=args.load_factor)
    t0 = time.perf_counter()
    index = build_index(args.fasta, gtf_path=args.gtf, cfg=cfg)
    index.save(args.output)
    logging.info(
        "indexed %d transcripts / %d k-mers / %d ECs in %.1fs -> %s",
        index.num_transcripts, index.num_kmers, index.num_ecs,
        time.perf_counter() - t0, args.output,
    )
    return 0


def _add_infer(sub):
    p = sub.add_parser("infer", help="quantify reads against an index")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("index", help="index file from `index`")
    p.add_argument("output_dir", help="output directory")
    p.add_argument("fastq", nargs="+", help="FASTQ(.gz) files")
    p.add_argument("--mates", nargs="*", default=None,
                   help="mate-2 FASTQ files (paired-end)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the run "
                        "fails rather than fall back when it is absent)")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--max-ecs-per-read", type=int, default=16)
    p.add_argument("--sig-table-bits", type=int, default=20)
    p.add_argument("--fragment-length", type=float, default=None,
                   help="fragment-length mean (default: estimated from "
                        "mapped pairs for paired-end runs, else 200)")
    p.add_argument("--fragment-sd", type=float, default=None,
                   help="fragment-length sd; > 0 switches the effective-"
                        "length model to the truncated-normal expectation "
                        "(default: estimated from mapped pairs for "
                        "paired-end runs, else 0)")
    p.add_argument("--em-tolerance", type=float, default=1e-4)
    p.add_argument("--em-max-iters", type=int, default=10000)
    p.add_argument("--em-accel", choices=("none", "squarem"), default="none")
    p.add_argument("--bootstrap", type=int, default=0,
                   help="number of bootstrap replicates")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the bootstrap resampling")
    p.add_argument("--x64", action="store_true", help="float64 EM")
    p.add_argument("--probe-sample", type=int, default=0,
                   help="fast mode: sample every Nth window; reads whose "
                        "samples name one EC resolve early, the rest "
                        "re-probe densely (an approximation; 0 = exact "
                        "dense)")
    p.add_argument("--sample-fallback", type=float, default=0.0,
                   help="the JAX package's fast-mode phase-2 cap fraction; "
                        "validated and ignored here")
    p.add_argument("--io-workers", type=int, default=0,
                   help="concurrent FASTQ decode threads (0 = auto, "
                        "1 = serial)")
    # the JAX package's TPU-only knobs: accepted, ignored (config.py)
    p.add_argument("--probe-chunks", type=int, default=0)
    p.add_argument("--pack-backend", choices=("xla", "pallas"),
                   default="xla")
    p.add_argument("--probe-backend", choices=("xla", "pallas"),
                   default="xla")
    p.add_argument("--sig-backend", choices=("xla", "pallas"), default="xla")
    p.add_argument("--no-h2d-pack", action="store_true")
    # features of the JAX CLI that are refused until they are ported
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--pack-cache", nargs="?", const="auto", default=None)
    p.add_argument("--probe-stride", type=int, default=1)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--data-shards", type=int, default=1)
    p.add_argument("--index-shards", type=int, default=1)
    p.add_argument("--distributed", action="store_true")
    return p


def build_parser() -> argparse.ArgumentParser:
    from . import __version__

    ap = argparse.ArgumentParser(
        prog="seekmer_tpu_torch",
        description="RNA-seq quantification (k-mer pseudoalignment + EM) "
                    "on PyTorch/CUDA")
    ap.add_argument("--version", action="version",
                    version=f"seekmer_tpu_torch {__version__}")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_index(sub)
    _add_infer(sub)
    fuse = sub.add_parser("fuse", help="fusion calling (not ported yet)")
    fuse.add_argument("rest", nargs=argparse.REMAINDER)
    return ap


def _refuse_unported(args) -> None:
    if args.checkpoint:
        raise NotPorted("--checkpoint", "Checkpoints")
    if args.pack_cache is not None:
        raise NotPorted("--pack-cache", "Pack cache")
    if args.probe_stride > 1:
        raise NotPorted("--probe-stride > 1", "Strided mode")
    if args.trace_dir:
        raise NotPorted("--trace-dir", "Tooling")
    if args.data_shards != 1 or args.index_shards != 1:
        raise NotPorted("sharding", "Multi-GPU")
    if args.distributed:
        raise NotPorted("--distributed", "Multi-GPU")


def kernel_launches() -> dict:
    """Launch counts of the kernel wrappers in this process."""
    from .ops import (accumulate_cuda, em_cuda, fast_cuda, pack_cuda,
                      probe_cuda, sig_cuda)

    return {"pack": pack_cuda.pack_canonical_2bit.launches,
            "lookup": probe_cuda.lookup_ecs_aux.launches,
            "signature": sig_cuda.read_signatures.launches,
            "accumulate": accumulate_cuda.fold_batch.launches,
            "em": em_cuda.em_fixed_point.launches,
            "sample": fast_cuda.sample_classify.launches,
            "merge": fast_cuda.merge_staging.launches}


def cmd_infer(args) -> int:
    import torch

    from .config import EMConfig, MapConfig, PipelineConfig
    from .index.store import KMerIndex
    from .io.writer import (write_abundance, write_bootstrap,
                            write_gene_abundance, write_h5, write_run_info)
    from .map.driver import check_device
    from .models.quantifier import Quantifier

    _refuse_unported(args)
    device = check_device(args.device)
    start_time = time.strftime("%Y-%m-%dT%H:%M:%S")
    index = KMerIndex.load(args.index)
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=args.batch_size,
                      max_ecs_per_read=args.max_ecs_per_read,
                      sig_table_bits=args.sig_table_bits,
                      paired_end=bool(args.mates),
                      probe_sample=args.probe_sample,
                      sample_fallback_frac=args.sample_fallback,
                      io_workers=args.io_workers,
                      probe_chunks=args.probe_chunks,
                      pack_backend=args.pack_backend,
                      probe_backend=args.probe_backend,
                      sig_backend=args.sig_backend,
                      h2d_pack_2bit=not args.no_h2d_pack),
        em=EMConfig(
            mean_fragment_length=(200.0 if args.fragment_length is None
                                  else args.fragment_length),
            fragment_length_sd=(0.0 if args.fragment_sd is None
                                else args.fragment_sd),
            # explicit FLD flags override data-driven estimation
            estimate_fld=(args.fragment_length is None
                          and args.fragment_sd is None),
            rel_tol=args.em_tolerance,
            max_iters=args.em_max_iters,
            accel=args.em_accel,
            bootstrap_samples=args.bootstrap,
            bootstrap_seed=args.seed,
            use_x64=args.x64),
    )
    q = Quantifier(index, cfg, device=device)
    result = q.quantify_files(args.fastq, mate_paths=args.mates or None)

    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "abundance.tsv")
    write_abundance(out, result.names, result.lengths, result.eff_length,
                    result.est_counts, result.tpm)
    if not write_h5(os.path.join(args.output_dir, "abundance.h5"),
                    result.names, result.lengths, result.eff_length,
                    result.est_counts, boot_counts=result.bootstrap_counts,
                    run_info={"total_reads": result.total_reads,
                              "call": " ".join(sys.argv),
                              "start_time": start_time}):
        logging.warning("h5py not installed; abundance.h5 not written")
    if result.bootstrap_counts is not None:
        write_bootstrap(os.path.join(args.output_dir, "bootstrap.npz"),
                        result.names, result.bootstrap_counts)
    if index.genes is not None:
        write_gene_abundance(
            os.path.join(args.output_dir, "abundance.genes.tsv"),
            index.genes, result.est_counts, result.tpm)
    write_run_info(
        os.path.join(args.output_dir, "run_info.json"),
        {
            "total_reads": result.total_reads,
            "mapped": result.mapped,
            "unmapped": result.unmapped,
            "p_mapped": result.mapped / max(result.total_reads, 1),
            "em_iterations": result.em_iterations,
            "log_likelihood": result.log_likelihood,
            "fld": (None if result.fld_mean is None else
                    {"mean": result.fld_mean, "sd": result.fld_sd,
                     "samples": result.fld_samples}),
            "bootstrap_samples": args.bootstrap,
            # 0 = dense, exact; >= 2 = fast mode's approximation
            "probe_sample": args.probe_sample,
            "start_time": start_time,
            "timings": result.timings,
            "index": args.index,
            "n_targets": int(index.num_transcripts),
            "device": (str(device) if device.type != "cuda" else
                       f"{device} ({torch.cuda.get_device_name(device)})"),
            "kernel_launches": kernel_launches(),
        },
    )
    logging.info("wrote %s (%d/%d reads mapped, %d EM iters)", out,
                 result.mapped, result.total_reads, result.em_iterations)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False)
        else logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    np.set_printoptions(precision=4, suppress=True)
    if args.command == "index":
        return cmd_index(args)
    if args.command == "infer":
        return cmd_infer(args)
    raise NotPorted("fuse", "Fusion mode")
