"""The port's native host code: C sources built with the system C compiler
at first use into ``build/seekmer_tpu_torch/`` at the repository root (the
directory the CUDA kernels are built into, ``ops/_build.py``), never beside
the source, and loaded with ``ctypes``."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "seekmer_tpu_torch"


def build_c(src: Path, stem: str, *args: str) -> Path:
    """``cc -O3 -shared -fPIC src args`` into ``BUILD_DIR/<stem>_<hash of
    src>.so`` unless that file exists; returns its path. The hash in the
    name means an edited source is never served by a stale build. Raises
    ``RuntimeError`` when no C compiler is found or the build fails."""
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"{stem}_{digest}.so"
    if out.exists():
        return out
    cc = next((c for c in ("cc", "gcc", "clang") if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError(f"no C compiler: {src.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        r = subprocess.run([cc, "-O3", "-shared", "-fPIC", str(src), *args,
                            "-o", so], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{r.stderr}")
        os.replace(so, out)  # atomic: a concurrent loader sees all or none
    return out
