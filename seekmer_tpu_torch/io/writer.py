"""Abundance output: the ``target_id, length, eff_length, est_counts, tpm``
table, the gene table, kallisto-compatible ``abundance.h5``, bootstrap
replicates and the JSON run info. The port's copy of
``seekmer_tpu/io/writer.py`` without ``write_fusions`` (fusion mode is not
ported); both write byte-equal tables from equal inputs."""

from __future__ import annotations

import json
from typing import Dict

import numpy as np


def write_abundance(
    path: str,
    names: np.ndarray,
    lengths: np.ndarray,
    eff_lengths: np.ndarray,
    est_counts: np.ndarray,
    tpm: np.ndarray,
) -> None:
    with open(path, "w") as fh:
        fh.write("target_id\tlength\teff_length\test_counts\ttpm\n")
        for i in range(len(names)):
            fh.write(
                f"{names[i]}\t{int(lengths[i])}\t{eff_lengths[i]:.6g}\t"
                f"{est_counts[i]:.6g}\t{tpm[i]:.6g}\n"
            )


def write_gene_abundance(
    path: str,
    genes: np.ndarray,
    est_counts: np.ndarray,
    tpm: np.ndarray,
) -> None:
    """Transcript table aggregated to gene level (requires GTF metadata at
    index time)."""
    uniq, inv = np.unique(genes, return_inverse=True)
    g_counts = np.bincount(inv, weights=est_counts, minlength=uniq.size)
    g_tpm = np.bincount(inv, weights=tpm, minlength=uniq.size)
    with open(path, "w") as fh:
        fh.write("gene_id\test_counts\ttpm\n")
        for i, g in enumerate(uniq):
            fh.write(f"{g}\t{g_counts[i]:.6g}\t{g_tpm[i]:.6g}\n")


def write_h5(
    path: str,
    names: np.ndarray,
    lengths: np.ndarray,
    eff_lengths: np.ndarray,
    est_counts: np.ndarray,
    boot_counts=None,
    run_info: Dict | None = None,
) -> bool:
    """kallisto-compatible ``abundance.h5`` (the format sleuth and other
    downstream tools consume): /est_counts, /aux/{ids,lengths,eff_lengths,
    num_bootstrap,...}, /bootstrap/bs{i}. Returns False (no file) when
    h5py is unavailable in the environment."""
    try:
        import h5py
    except ImportError:
        return False
    B = 0 if boot_counts is None else int(boot_counts.shape[0])
    info = run_info or {}
    with h5py.File(path, "w") as f:
        f.create_dataset("est_counts",
                         data=np.asarray(est_counts, np.float64))
        aux = f.create_group("aux")
        aux.create_dataset(
            "ids", data=np.array([str(n) for n in names], dtype="S"))
        aux.create_dataset("lengths", data=np.asarray(lengths, np.int32))
        aux.create_dataset("eff_lengths",
                           data=np.asarray(eff_lengths, np.float64))
        aux.create_dataset("num_bootstrap",
                           data=np.array([B], np.int32))
        aux.create_dataset("num_processed", data=np.array(
            [int(info.get("total_reads", 0))], np.int64))
        aux.create_dataset("kallisto_version",
                           data=np.bytes_("seekmer_tpu"))
        aux.create_dataset("index_version", data=np.array([1], np.int64))
        aux.create_dataset("start_time",
                           data=np.bytes_(str(info.get("start_time", ""))))
        aux.create_dataset("call", data=np.bytes_(str(info.get("call", ""))))
        if B:
            bs = f.create_group("bootstrap")
            for i in range(B):
                bs.create_dataset(
                    f"bs{i}", data=np.asarray(boot_counts[i], np.float64))
    return True


def write_bootstrap(path: str, names: np.ndarray, boot_counts: np.ndarray) -> None:
    """Bootstrap est_counts matrix (replicates x transcripts) as npz."""
    np.savez_compressed(path, names=names.astype("S"), est_counts=boot_counts)


def write_run_info(path: str, info: Dict) -> None:
    with open(path, "w") as fh:
        json.dump(info, fh, indent=2, default=str)
        fh.write("\n")


def read_abundance(path: str) -> Dict[str, np.ndarray]:
    names, lengths, eff, counts, tpm = [], [], [], [], []
    with open(path) as fh:
        header = fh.readline()
        assert header.startswith("target_id"), f"bad abundance header: {header!r}"
        for line in fh:
            f = line.rstrip("\n").split("\t")
            names.append(f[0])
            lengths.append(int(f[1]))
            eff.append(float(f[2]))
            counts.append(float(f[3]))
            tpm.append(float(f[4]))
    return {
        "target_id": np.array(names),
        "length": np.array(lengths),
        "eff_length": np.array(eff),
        "est_counts": np.array(counts),
        "tpm": np.array(tpm),
    }
