"""Host code the port shares with ``seekmer_tpu``, gathered for its users.

These modules of the JAX package never import JAX (``seekmer_tpu/__init__``
tolerates its absence), so the port imports them rather than copying them:
index storage, the 2-bit read packer whose bits the pack kernel reads, the
abundance table reader, and the read simulator that makes test and smoke
worlds. A script that drives the port imports them from here.
"""

from seekmer_tpu.encoding import pack_codes_2bit  # noqa: F401
from seekmer_tpu.index.store import KMerIndex  # noqa: F401
from seekmer_tpu.io.fastq import (  # noqa: F401
    batch_read_pairs_native,
    batch_reads_native,
)
from seekmer_tpu.io.writer import read_abundance  # noqa: F401
from seekmer_tpu.utils.simulate import (  # noqa: F401
    isoform_transcriptome,
    random_transcriptome,
    simulate_packed_batches,
    simulate_packed_pairs,
    simulate_reads,
    write_fasta,
    write_fastq,
)
