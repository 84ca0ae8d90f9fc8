"""Command-line interface of the port: ``index`` (the host index build,
``_add_index`` and ``cmd_index`` copied from ``seekmer_tpu/cli.py``; the
file loads in either package), ``infer`` and ``fuse`` on one device,
``--device cuda`` by default.

``infer`` estimates the fragment-length distribution of paired runs unless
``--fragment-length`` or ``--fragment-sd`` is given, runs ``--bootstrap``
replicates, maps in fast mode with ``--probe-sample N`` (N >= 2) and in
strided mode with ``--probe-stride N`` (N > 1). ``--checkpoint F``
saves a map checkpoint every ``--checkpoint-every`` batches and EM and
bootstrap snapshots beside it, and resumes from them; ``--pack-cache
[DIR]`` feeds the pre-packed batch cache, building it on the first run;
``--trace-dir D`` writes a ``torch.profiler`` trace of the run into D. It
parses every ``infer`` flag of the JAX CLI:

- ``--sample-fallback`` (validated, then ignored: the port re-probes every
  fallback unit in one pass) and ``--io-workers`` go into ``MapConfig``;
- ``--probe-chunks``, ``--pack-backend``, ``--probe-backend``,
  ``--sig-backend`` and ``--no-h2d-pack`` go into ``MapConfig`` too, whose
  fields for them the port ignores (``config.py``), but for
  ``--no-h2d-pack``, which ``--pack-cache`` refuses;
- ``--data-shards N`` (N > 1) starts N ranks on this host, one a card
  (``cuda:0`` .. ``cuda:N-1``; a host with fewer cards is refused) or N
  CPU ranks with ``--device cpu``, joins them, and fails when one fails
  (``parallel/comm.launch``); ``--distributed`` joins the group
  ``torchrun`` describes, one rank a process on ``cuda:LOCAL_RANK``, the
  ranks of a host dealing the batches of the files on its command line
  (``--data-shards`` is then 1 or the world size). Rank 0 writes the
  outputs; ``run_info.json`` holds the ranks (``world_size``) and the
  kernels' launches summed over them;
- ``--index-shards N`` (N > 1, a power of two) cuts the index into N
  prefix shards, one a rank (``parallel/prefix_shard.py``): on one host
  ``--data-shards D --index-shards N`` starts D x N ranks as above, rank
  r holding shard r mod N and mapping its rows of every batch; under
  ``--distributed`` the world must be D x N, and a host's ranks, whole
  index groups, split the rows of the files on its command line.

``fuse`` (``_add_fuse`` and ``cmd_fuse`` after ``seekmer_tpu/cli.py``)
takes the JAX CLI's arguments and ``--device``, and writes the same
``fusions.tsv`` and ``run_info.json``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np


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
    p.add_argument("--probe-stride", type=int, default=1,
                   help="strided mode: probe every Nth window and fill the "
                        "gaps from the index's EC run lengths, probing the "
                        "windows neither side covers (1 = every window)")
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
    p.add_argument("--checkpoint", default=None,
                   help="map checkpoint file: save every "
                        "--checkpoint-every batches (EM and bootstrap "
                        "snapshots beside it) and resume from it")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--pack-cache", nargs="?", const="auto", default=None,
                   help="pre-packed 2-bit batch cache directory (default "
                        "<first fastq>.smpack): built on the first run, "
                        "memory-mapped by later runs")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the run there")
    p.add_argument("--data-shards", type=int, default=1,
                   help="ranks that map, one a card (cuda:0..N-1, or N "
                        "CPU ranks with --device cpu)")
    p.add_argument("--index-shards", type=int, default=1,
                   help="prefix-shard the index over this many ranks, one "
                        "shard a rank (a power of two; --data-shards x "
                        "--index-shards ranks in all)")
    p.add_argument("--distributed", action="store_true",
                   help="join the torch.distributed group torchrun "
                        "describes: one rank a process on cuda:LOCAL_RANK; "
                        "a host's ranks deal the batches of its files")
    return p


def _add_fuse(sub):
    p = sub.add_parser("fuse", help="call fusion-transcript candidates from "
                                    "discordant read pairs")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("index", help="index file from `index`")
    p.add_argument("output_dir", help="output directory")
    p.add_argument("fastq", nargs="+", help="mate-1 FASTQ(.gz) files")
    p.add_argument("--mates", nargs="+", required=True,
                   help="mate-2 FASTQ(.gz) files")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the run "
                        "fails rather than fall back when it is absent)")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--max-ecs-per-read", type=int, default=16)
    p.add_argument("--sig-table-bits", type=int, default=20)
    p.add_argument("--min-count", type=int, default=2,
                   help="minimum supporting pairs per candidate")
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
    _add_fuse(sub)
    return ap


def kernel_launches() -> dict:
    """Launch counts of the kernel wrappers in this process."""
    from .ops import (accumulate_cuda, em_csr_cuda, em_cuda, fast_cuda,
                      pack_cuda, probe_cuda, route_cuda, sig_cuda,
                      strided_cuda)

    return {"pack": pack_cuda.pack_canonical_2bit.launches,
            "lookup": probe_cuda.lookup_ecs_aux.launches,
            "signature": sig_cuda.read_signatures.launches,
            "accumulate": accumulate_cuda.fold_batch.launches,
            "em": em_cuda.em_fixed_point.launches,
            "sample": fast_cuda.sample_classify.launches,
            "merge": fast_cuda.merge_staging.launches,
            "em_csr": em_csr_cuda.em_steps.launches,
            "strided": strided_cuda.lookup_ecs_strided.launches,
            "ec_sum": em_csr_cuda.ec_sums.launches,
            # R1's two entries, and R2
            "route": (route_cuda.route_first.launches
                      + route_cuda.route_spill.launches),
            "unroute": route_cuda.unroute.launches}


def cmd_infer(args) -> int:
    from .map.driver import check_device
    from .parallel import comm

    if args.index_shards < 1:
        raise ValueError(f"--index-shards {args.index_shards} < 1")
    if args.distributed:
        device = comm.init_distributed(device=args.device)
        if args.index_shards > 1:
            if args.data_shards * args.index_shards != comm.world():
                raise ValueError(
                    f"--data-shards {args.data_shards} x --index-shards "
                    f"{args.index_shards} under --distributed: must be "
                    f"the world size {comm.world()}")
        elif args.data_shards not in (1, comm.world()):
            raise ValueError(f"--data-shards {args.data_shards} under "
                             f"--distributed: 1 or the world size "
                             f"{comm.world()}")
        # a host's ranks share the files named on its command line
        share = (int(os.environ.get("LOCAL_RANK", 0)),
                 int(os.environ.get("LOCAL_WORLD_SIZE", 1)))
        return _run_infer(args, check_device(device), comm.world(),
                          input_share=share)
    if args.data_shards < 1:
        raise ValueError(f"--data-shards {args.data_shards} < 1")
    if args.data_shards * args.index_shards > 1:
        return _launch_infer(args)
    return _run_infer(args, check_device(args.device), 1)


def _launch_infer(args) -> int:
    """``--data-shards D --index-shards N`` on one host: D x N ranks, rank
    r on ``cuda:r`` (or the CPU); with N = 1 each maps global batches r,
    r + D, ..., with N > 1 its rows of every batch against shard r mod
    N."""
    import torch

    from .map.driver import check_device
    from .parallel import comm

    n = args.data_shards * args.index_shards
    flags = (f"--data-shards {args.data_shards} --index-shards "
             f"{args.index_shards}")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} was requested but CUDA is not "
                               "available")
        if dev.index is not None:
            raise ValueError(f"{flags} takes --device cuda (rank r runs on "
                             "cuda:r) or --device cpu")
        if torch.cuda.device_count() < n:
            raise RuntimeError(f"{flags} needs {n} CUDA devices; this host "
                               f"has {torch.cuda.device_count()}")
        devices = [f"cuda:{r}" for r in range(n)]
    else:
        devices = [str(check_device(dev))] * n
    comm.launch(n, _infer_rank, (args,), devices=devices,
                threads=max(1, (os.cpu_count() or 1) // n))
    return 0


def _infer_rank(rank: int, device, args) -> int:
    """A rank of ``_launch_infer``, in its own process."""
    from .parallel import comm

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format=f"[%(asctime)s %(levelname)s rank {rank} %(name)s] "
               "%(message)s")
    return _run_infer(args, device, comm.world())


def _run_infer(args, device, ranks: int, input_share=None) -> int:
    import torch

    from .config import EMConfig, MapConfig, PipelineConfig, ShardConfig
    from .index.store import KMerIndex
    from .io.writer import (write_abundance, write_bootstrap,
                            write_gene_abundance, write_h5, write_run_info)
    from .models.quantifier import Quantifier
    from .parallel import comm
    from .utils.profiling import maybe_trace

    start_time = time.strftime("%Y-%m-%dT%H:%M:%S")
    index = KMerIndex.load(args.index)
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=args.batch_size,
                      max_ecs_per_read=args.max_ecs_per_read,
                      sig_table_bits=args.sig_table_bits,
                      paired_end=bool(args.mates),
                      probe_stride=args.probe_stride,
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
        shard=(ShardConfig(data_axis=ranks // args.index_shards,
                           index_axis=args.index_shards,
                           index_mode="prefix")
               if args.index_shards > 1 else ShardConfig(data_axis=ranks)),
    )
    q = Quantifier(index, cfg, device=device, input_share=input_share)
    label = "infer" if ranks == 1 else f"infer.rank{comm.rank()}"
    with maybe_trace(args.trace_dir, label):
        result = q.quantify_files(args.fastq, mate_paths=args.mates or None,
                                  checkpoint_path=args.checkpoint,
                                  checkpoint_every=args.checkpoint_every,
                                  pack_cache=args.pack_cache)
    launches = kernel_launches()
    if ranks > 1:
        summed = comm.allreduce(np.asarray(list(launches.values()),
                                           np.int64))
        launches = dict(zip(launches, (int(v) for v in summed)))
        if comm.rank() != 0:
            return 0

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
            # 1 = every window probed; > 1 = strided mode
            "probe_stride": args.probe_stride,
            "start_time": start_time,
            "timings": result.timings,
            "index": args.index,
            "n_targets": int(index.num_transcripts),
            "device": (str(device) if device.type != "cuda" else
                       f"{device} ({torch.cuda.get_device_name(device)})"),
            # ranks, one a card; the launches are summed over them
            "world_size": ranks,
            "kernel_launches": launches,
        },
    )
    logging.info("wrote %s (%d/%d reads mapped, %d EM iters)", out,
                 result.mapped, result.total_reads, result.em_iterations)
    return 0


def cmd_fuse(args) -> int:
    from .config import MapConfig
    from .fusion import detect_fusions_files
    from .index.store import KMerIndex
    from .io.writer import write_fusions, write_run_info
    from .map.driver import check_device

    device = check_device(args.device)
    index = KMerIndex.load(args.index)
    cfg = MapConfig(batch_size=args.batch_size,
                    max_ecs_per_read=args.max_ecs_per_read,
                    sig_table_bits=args.sig_table_bits)
    report = detect_fusions_files(index, args.fastq, args.mates, cfg=cfg,
                                  min_count=args.min_count, device=device)
    os.makedirs(args.output_dir, exist_ok=True)
    out = os.path.join(args.output_dir, "fusions.tsv")
    write_fusions(out, report)
    write_run_info(
        os.path.join(args.output_dir, "run_info.json"),
        {
            "pairs_total": report.pairs_total,
            "candidates": len(report.candidates),
            "split_reads": report.split_reads,
            "concordant": report.concordant,
            "same_gene_discordant": report.same_gene_discordant,
            "ambiguous": report.ambiguous,
            "unresolved": report.unresolved,
            "min_count": args.min_count,
            "index": args.index,
        },
    )
    logging.info("wrote %s (%d candidates)", out, len(report.candidates))
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
    if args.command == "fuse":
        return cmd_fuse(args)
    raise AssertionError(args.command)
