"""Streaming FASTA parsing for the index build: the port's copy of
``seekmer_tpu/io/fasta.py``."""

from __future__ import annotations

import gzip
import io
from typing import Iterator, Tuple


def _open_text(path: str):
    if str(path).endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii")


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) per record. Name is the first whitespace token
    of the header (transcript id for transcriptome FASTAs)."""
    name = None
    chunks: list[str] = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0].split("|")[0]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)
