"""A tiny copy of the benchmark's cells for CPU tests: the real
configurations with a small world and sample, in a directory of their own
with the real metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from gpubench import manifest

HERE = manifest.HERE


# a world with sequence shared between genes (``worlds/gencode_families``):
# GENCODE's share of pseudogenes, assumed paralog shares and divergences
FAMILIES = {"generator": "gencode_families", "pseudogene_share": 0.23,
            "pseudogene_truncation": 0.5,
            "pseudogene_divergence": [0.01, 0.1], "paralog_share": 0.15,
            "paralog_divergence": [0.005, 0.05], "max_family": 4}


def make_root(tmp: Path, fragments_per_lane: int = 8192,
              bootstrap: int = 100) -> Path:
    """Write BENCHMARK.json, configs, traffic and metrics for the cells
    ``pe``, ``se``, ``pec`` (the pack-cache mix) and ``fam`` (``pe`` on a
    world of gene families and pseudogenes) under ``tmp``."""
    root = Path(tmp) / "bench"
    for d in ("configs", "traffic"):
        (root / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", root / "metrics", dirs_exist_ok=True)
    for src, name in (("gencode_pe100", "tiny_pe"),
                      ("gencode_se75", "tiny_se")):
        c = manifest.load_config(src)
        c["name"] = name
        c["world"]["num_genes"] = 40
        # the real profile's ranks spread so a tiny world keeps most of
        # its transcripts expressed, as the full one does
        c["world"]["expression"]["full_transcripts"] = 20000
        c["map"]["batch_size"] = 4096
        c["map"]["sig_table_bits"] = 16
        # EM's cap cut so that a CPU run takes seconds; the tiny
        # reference holds the program to the same cap
        c["em"]["max_iters"] = 2000
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
        if name == "tiny_pe":
            c["name"] = "tiny_fam"
            c["world"].update(FAMILIES, num_genes=60)
            # a cap that some of its fragments pass (none passes 16 at
            # this size), so that complex fragments are dropped
            c["map"]["max_ecs_per_read"] = 7
            (root / "configs" / "tiny_fam.json").write_text(json.dumps(c))
    for name, inp in (("tiny", "fastq"), ("tiny_cached", "pack_cache")):
        (root / "traffic" / f"{name}.json").write_text(json.dumps(
            {"name": name, "lanes": 4,
             "fragments_per_lane": fragments_per_lane,
             "em": {"bootstrap_samples": bootstrap}, "input": inp,
             "loop": "closed"}))
    b = manifest.load_benchmark()
    b["workloads"] = [
        {"name": "pe", "config": "tiny_pe", "traffic": "tiny", "chips": 1},
        {"name": "se", "config": "tiny_se", "traffic": "tiny", "chips": 1},
        {"name": "pec", "config": "tiny_pe", "traffic": "tiny_cached",
         "chips": 1},
        {"name": "fam", "config": "tiny_fam", "traffic": "tiny", "chips": 1}]
    for m in b["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root
