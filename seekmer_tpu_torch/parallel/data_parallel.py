"""Data-parallel mapping over ranks, one card a rank; counterpart of
``seekmer_tpu/parallel/data_parallel.py``.

The JAX package cuts each global batch over the mesh's ``reads`` axis and
runs the map step under ``shard_map`` on every device of one process (each
host feeding its local rows through
``jax.make_array_from_process_local_data``). Here a rank maps whole
batches on its own card with the single-card ``Mapper`` (2-bit upload,
every map mode), and which batches are its own is decided before upload:

- the ranks that are given the same input (``input_share`` = (this
  rank's place among them, their number); every rank of the group by
  default, as ``--data-shards N`` on one host) each read all of it and
  keep global batch g where g mod n is their place (``io/fastq.
  rank_batches``), so every read is mapped once and the merged counts
  equal the one-card run's. Each rank decodes all of that input: n times
  the decode on n cores, the price of this first version;
- under ``--distributed`` the ranks of one host share its input, the JAX
  package's per-host shard (``torchrun``'s ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE``); hosts read different files.

``finalize`` gathers every rank's occupied rows (``table_to_host``: the
fingerprint rows and the per-EC direct counts as single-EC rows) by an
all-gather of their sizes and then of the padded rows, sums the read,
overflow and collision counters by an all-reduce, and merges the rows on
every rank (``merge_sig_rows``): the tables themselves stay on their
cards. The FLD estimator samples this rank's share of the batches one card
samples, and the ranks' histograms are summed before the estimate
(``map/fld.py``, fault 5). Checkpoints are the multi-process protocol of
``parallel/ckpt_mp.py``; their feed loop is
``map/driver._run_with_checkpoints_multiprocess``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

from ..config import MapConfig, ShardConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch, rank_batches
from ..map.driver import MapResult, Mapper, merge_sig_rows
from ..map.fld import SAMPLE_BATCHES, FLDEstimator
from ..map.signature import table_to_host
from . import comm


def data_ranks(shard: ShardConfig) -> int:
    """The ranks ``shard`` asks to map with: ``data_axis``, or every rank
    of the group for 0 or -1. It must be the group's size."""
    n = shard.data_axis if shard.data_axis > 0 else comm.world()
    if n != comm.world():
        raise ValueError(f"ShardConfig.data_axis {shard.data_axis} needs "
                         f"{n} ranks; the process group has {comm.world()}")
    return n


class RankMapper:
    """What a mapper on several ranks does the same whatever cuts its work
    (``DataParallelMapper`` here, ``prefix_shard.PrefixShardedMapper``):
    the collective feed loop with checkpoints, the multi-process checkpoint
    (``ckpt_mp.py``), the FLD histograms summed, and ``finalize``'s merge
    of every rank's table. A subclass sets ``table``, ``total_reads``,
    ``fld``, ``n_ranks``, ``restored_cursor`` (None) and ``_ckpt_step``
    (0), and makes its estimator in ``make_fld_estimator(state)``."""

    def supports_checkpoint(self) -> bool:
        return True

    def fld_histogram(self) -> np.ndarray:
        """The ranks' FLD histograms summed (collective; a rank without an
        estimator adds zeros)."""
        from ..map.fld import MAX_LEN

        local = (np.zeros(MAX_LEN + 1, np.int64) if self.fld is None
                 else self.fld.hist.cpu().numpy().astype(np.int64))
        return comm.allreduce(local)

    def run(self, batches: Iterable[ReadBatch],
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50) -> MapResult:
        from ..map.driver import _run_with_checkpoints_multiprocess

        if checkpoint_path:
            return _run_with_checkpoints_multiprocess(
                self, batches, checkpoint_path, checkpoint_every)
        for batch in batches:
            self.feed(batch)
        return self.finalize()

    def save_checkpoint(self, path: str,
                        stream_state: Optional[dict] = None) -> None:
        """Collective: every rank calls it at the same round."""
        from .ckpt_mp import save_mapper_checkpoint

        save_mapper_checkpoint(self, path, stream_state)

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        """This rank's part of a multi-process checkpoint: its table, read
        count and FLD state, and its cursor ({} without one), or None when
        there is no checkpoint."""
        from .ckpt_mp import restore_mapper_checkpoint

        state = restore_mapper_checkpoint(self, path)
        if state:
            self.restored_cursor = state
        return state

    def finalize(self) -> MapResult:
        sigs, counts = table_to_host(self.table)
        sigs = np.concatenate(comm.allgather_rows(sigs))
        counts = np.concatenate(comm.allgather_rows(counts))
        total, overflow, collisions = (int(v) for v in comm.allreduce(
            np.asarray([self.total_reads, int(self.table.overflow),
                        int(self.table.collisions)], np.int64)))
        return merge_sig_rows(sigs, counts, total, overflow,
                              collisions=collisions)


class DataParallelMapper(RankMapper, Mapper):
    """A rank's ``Mapper`` that takes its share of the batches and merges
    with the other ranks at ``finalize``."""

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 shard: ShardConfig = ShardConfig(), device="cuda",
                 input_share: Optional[Tuple[int, int]] = None):
        super().__init__(index, cfg, device=device)
        self.n_ranks = data_ranks(shard)
        self.rank = comm.rank()
        self.place, self.sharers = (input_share if input_share is not None
                                    else (self.rank, self.n_ranks))
        # a restored checkpoint's cursor, the one to save again when the
        # stream has nothing after it, and the global index of the next
        # batch (its "batch"), from which rank_batches deals
        self.restored_cursor = None
        self.first_batch = 0
        self._ckpt_step = 0

    def select(self, batches: Iterable[ReadBatch]) -> Iterator[ReadBatch]:
        """This rank's batches of the stream it reads."""
        return rank_batches(batches, self.place, self.sharers,
                            self.first_batch)

    @property
    def fld_batches(self) -> int:
        """The paired batches this rank samples for the FLD: its own among
        the first SAMPLE_BATCHES of the stream it shares."""
        return len(range(self.place, SAMPLE_BATCHES, self.sharers))

    def make_fld_estimator(self, state=None):
        if self.index.fld_tid is None:
            return None
        self.fld = FLDEstimator(self.index, self.device_index, state,
                                sample_batches=self.fld_batches)
        return self.fld

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        state = super().restore_checkpoint(path)
        if state:
            self.first_batch = int(state.get("batch", 0))
        return state
