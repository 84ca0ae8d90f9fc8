"""seekmer_tpu_torch: the PyTorch/CUDA port of seekmer_tpu.

The dense mapping path (canonical k-mer packing, bucket lookup with the
stash, per-read EC signatures, signature-table accumulate) and the dense
EM fixed point of the bootstrap run through hand-written CUDA kernels for
Hopper (``csrc/``); single-run CSR EM, the batched CSR bootstrap EM and
fragment-length estimation run on torch ops around them. The host code
(configuration, encoding, index build and storage, FASTQ ingest and its C
library, the writer, the simulator) is the port's own copy: the package
imports neither JAX nor ``seekmer_tpu``.

Every entry point takes an explicit ``device``. A CUDA tensor always goes
through its kernel; the plain PyTorch versions run only on CPU tensors.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401,E402
    EMConfig,
    IndexConfig,
    MapConfig,
    PipelineConfig,
    ShardConfig,
)
