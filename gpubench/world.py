"""A deployment's fixed world, made once a checkout and kept in the cache
directory (``gpubench/.cache``), each part under a key of what made it:

- ``worlds/<generator>-<w>``: the transcriptome from the configuration's
  own seed (FASTA, GTF, and the codes, lengths and expression profile the
  samples are drawn from); w hashes the world's parameters and
  ``simulate.py``, and the generator's own file where it has one;
- ``index/<w>-<p>``: the program's index, built by its ``index`` command
  with the configuration's ``index`` settings as its options, as a user
  builds one; p hashes those settings and the program's sources that
  shape the index file;
- ``reftab/<w>-<r>``: the reference's k-mer table, made from the
  transcript sequences by ``reference/kmers.py`` (r hashes it).

The world group's ``generator`` names the transcriptome's maker:
``isoform_transcriptome`` is ``simulate.py``'s; any other name is the
file ``worlds/<generator>.py``, whose ``make(rng, params)`` returns
(names, seqs, gene ids) from the world's generator and its parameters, so
a deployment brings its world as a new file.

Each part is made in a directory of its own and renamed into place when
whole, so a run that is cut leaves no half-made part behind.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np

from . import manifest, simulate

HERE = Path(__file__).resolve().parent
# the program's sources that decide the bytes of its index file
PROGRAM_INDEX_SOURCES = ("index", "io", "encoding.py", "config.py",
                         "ops/hash.py", "native/packer.c",
                         "native/packer.py", "native/__init__.py")


def _digest(*parts) -> str:
    h = hashlib.sha1()
    for p in parts:
        h.update(p if isinstance(p, bytes) else str(p).encode())
        h.update(b"\0")
    return h.hexdigest()[:16]


def _tree_bytes(root: Path, rel) -> list:
    out = []
    for r in rel:
        p = root / r
        files = sorted(p.rglob("*")) if p.is_dir() else [p]
        for f in files:
            if f.is_file() and f.suffix in (".py", ".c", ".h"):
                out += [str(f.relative_to(root)).encode(), f.read_bytes()]
    return out


def program_root() -> Path:
    import seekmer_tpu_torch

    return Path(seekmer_tpu_torch.__file__).resolve().parent


@dataclasses.dataclass
class World:
    index: Path  # the program's index file
    reftab: Path  # the reference's k-mer table
    lengths: np.ndarray  # transcript lengths
    concat: np.ndarray  # the transcripts' codes, back to back
    expression: np.ndarray  # relative molecule counts, or None (uniform)
    made_s: float  # seconds spent here making the world and the table


def _make(target: Path, fn: Callable[[Path], None]) -> bool:
    """Make ``target`` with ``fn(dir)`` unless it is there; True if made."""
    if (target / "done").exists():
        return False
    part = target.with_name(target.name + ".part")
    shutil.rmtree(part, ignore_errors=True)
    part.mkdir(parents=True)
    fn(part)
    (part / "done").write_text("")
    shutil.rmtree(target, ignore_errors=True)
    os.replace(part, target)
    return True


def _isoform_transcriptome(rng: np.random.Generator, wp: dict):
    return simulate.isoform_transcriptome(
        rng, wp["num_genes"], wp["mean_isoforms"], wp["mean_exons"],
        wp["mean_exon_len"])


def generator(name: str):
    """(make, the bytes its worlds are keyed by beside ``simulate.py``) of
    the world generator ``name``; ValueError where there is none."""
    if name == "isoform_transcriptome":
        return _isoform_transcriptome, ()
    mod = manifest.load_module("worlds", "world generator", name, HERE)
    return mod.make, (Path(mod.__file__).read_bytes(),)


def ensure_world(wp: dict, cache: Path, log: Callable[[str], None]
                 ) -> Tuple[Path, float]:
    """The directory of the world of parameters ``wp`` (a configuration's
    ``world`` group), made unless it is there, and the seconds spent
    making it."""
    make, keyed = generator(wp["generator"])
    wkey = _digest(json.dumps(wp, sort_keys=True),
                   (HERE / "simulate.py").read_bytes(), *keyed)
    wdir = cache / "worlds" / f"{wp['generator']}-{wkey}"

    def make_world(d: Path):
        rng = np.random.default_rng(wp["seed"])
        names, seqs, genes = make(rng, wp)
        ex = wp.get("expression")
        expr = (np.ones(len(seqs)) / len(seqs) if ex is None else
                simulate.power_law_expression(rng, len(seqs), ex["k"],
                                              ex["x1"],
                                              ex["full_transcripts"]))
        with open(d / "transcripts.fa", "w") as fh:
            for n, s in zip(names, seqs):
                fh.write(f">{n}\n{s}\n")
        with open(d / "transcripts.gtf", "w") as fh:
            for n, g in zip(names, genes):
                fh.write(f'chr1\tsim\ttranscript\t1\t2\t.\t+\t.\t'
                         f'gene_id "{g}"; transcript_id "{n}";\n')
        concat = simulate.seq_to_codes("".join(seqs))
        lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
        np.savez(d / "world.npz", concat=concat, lengths=lens,
                 expression=expr)

    t0 = time.perf_counter()
    made_s = 0.0
    if _make(wdir, make_world):
        made_s = time.perf_counter() - t0
        log(f"[world] made {wdir.name} in {made_s:.3f} s")
    return wdir, made_s


def ensure(cfg: dict, cache: Path, device, log: Callable[[str], None]
           ) -> World:
    wdir, made_s = ensure_world(cfg["world"], cache, log)
    with np.load(wdir / "world.npz") as z:
        concat, lens, expr = z["concat"], z["lengths"], z["expression"]

    ix = cfg["index"]
    k = ix["kmer_length"]
    pkey = _digest(json.dumps(ix, sort_keys=True),
                   *_tree_bytes(program_root(), PROGRAM_INDEX_SOURCES))
    idir = cache / "index" / f"{wdir.name}-{pkey}"

    def make_index(d: Path):
        from seekmer_tpu_torch import cli

        opts = [a for key, v in sorted(ix.items())
                for a in ("--" + key.replace("_", "-"), str(v))]
        rc = cli.main(["index", str(wdir / "transcripts.fa"),
                       str(d / "index.npz"), "--gtf",
                       str(wdir / "transcripts.gtf")] + opts)
        if rc != 0:
            raise RuntimeError(f"the program's index build returned {rc}")

    t0 = time.perf_counter()
    if _make(idir, make_index):
        log(f"[world] the program built its index {idir.name} in "
            f"{time.perf_counter() - t0:.3f} s")

    rkey = _digest(k, (HERE / "reference" / "kmers.py").read_bytes())
    rdir = cache / "reftab" / f"{wdir.name}-{rkey}"

    def make_table(d: Path):
        import torch

        from .reference import kmers

        tab = kmers.build_table(torch.from_numpy(concat).to(device),
                                torch.from_numpy(lens).to(device), k)
        torch.save({n: t.cpu() for n, t in tab.items()}, d / "table.pt")

    t0 = time.perf_counter()
    if _make(rdir, make_table):
        made_s += time.perf_counter() - t0
        log(f"[world] made the reference table {rdir.name} in "
            f"{time.perf_counter() - t0:.3f} s")
    return World(idir / "index.npz", rdir / "table.pt", lens, concat, expr,
                 made_s)


def sample(w: World, cfg: dict, mix: dict, seed: int):
    """The cell's sample from ``seed``: per-lane code rows of mate 1 and
    of mate 2 (None entries for single-end reads)."""
    rd = cfg["reads"]
    return simulate.draw_sample(
        seed, w.concat, w.lengths, mix["lanes"], mix["fragments_per_lane"],
        rd["read_len"], bool(cfg["map"]["paired_end"]), rd["mean_frag"],
        rd["sd_frag"], rd["error_rate"], w.expression)


def load_table(w: World, device) -> Dict:
    import torch

    tab = torch.load(w.reftab, map_location="cpu", weights_only=True)
    return {n: t.to(device) for n, t in tab.items()}
