"""Minimal GTF parsing, transcript -> gene, for the index build: the port's
copy of ``seekmer_tpu/io/gtf.py``."""

from __future__ import annotations

import gzip
import io
import re
from typing import Dict

_ATTR_RE = re.compile(r'(\w+) "([^"]*)"')


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii")


def transcript_gene_map(path: str) -> Dict[str, str]:
    """Parse a GTF and return {transcript_id: gene_id}. Uses 'transcript'
    feature rows when present, falling back to any row carrying both ids."""
    out: Dict[str, str] = {}
    with _open_text(path) as fh:
        for line in fh:
            if not line or line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            feature, attrs = parts[2], parts[8]
            if feature not in ("transcript", "exon", "mRNA"):
                continue
            d = dict(_ATTR_RE.findall(attrs))
            tid, gid = d.get("transcript_id"), d.get("gene_id")
            if tid and gid and tid not in out:
                out[tid] = gid
    return out
