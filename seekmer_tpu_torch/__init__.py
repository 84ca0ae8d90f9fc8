"""seekmer_tpu_torch: the PyTorch/CUDA port of seekmer_tpu.

The dense mapping path (canonical k-mer packing, bucket lookup with the
stash, per-read EC signatures, signature-table accumulate) and the dense
EM fixed point of the bootstrap run through hand-written CUDA kernels for
Hopper (``csrc/``); single-run CSR EM, the batched CSR bootstrap EM and
fragment-length estimation run on torch ops around them. Host code that never imports JAX (configuration, encoding, index
build and storage, FASTQ ingest, the writer, the simulator) is imported from
``seekmer_tpu`` unchanged.

Every entry point takes an explicit ``device``. A CUDA tensor always goes
through its kernel; the plain PyTorch versions run only on CPU tensors.
"""

__version__ = "0.1.0"

from seekmer_tpu.config import (  # noqa: F401,E402
    EMConfig,
    IndexConfig,
    MapConfig,
    PipelineConfig,
    ShardConfig,
)
