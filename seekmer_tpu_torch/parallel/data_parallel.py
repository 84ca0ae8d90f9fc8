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

``finalize`` is the one-card ``Mapper``'s, whose gather step here
all-gathers every rank's occupied rows (``table_to_host``: the
fingerprint rows and the per-EC direct counts as single-EC rows), their
sizes first, and sums the read, overflow and collision counters by an
all-reduce; every rank merges the rows (``merge_sig_rows``): the tables
themselves stay on their cards. The FLD estimator samples this rank's
share of the batches one card samples, and the ranks' histograms are
summed before the estimate (``map/fld.py``, fault 5). Checkpoints are the
multi-process protocol of ``parallel/ckpt_mp.py``, saved from
``RankMapper.run``'s collective feed loop.
"""

from __future__ import annotations

import logging
import zipfile
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from ..config import MapConfig, ShardConfig
from ..index.store import KMerIndex
from ..io.fastq import ReadBatch, rank_batches
from ..map.driver import MapResult, Mapper
from ..map.fld import MAX_LEN, SAMPLE_BATCHES, estimate_from_hist
from ..utils.metrics import Metrics
from . import comm

log = logging.getLogger(__name__)


def data_ranks(shard: ShardConfig) -> int:
    """The ranks ``shard`` asks to map with: ``data_axis``, or every rank
    of the group for 0 or -1. It must be the group's size."""
    n = shard.data_axis if shard.data_axis > 0 else comm.world()
    if n != comm.world():
        raise ValueError(f"ShardConfig.data_axis {shard.data_axis} needs "
                         f"{n} ranks; the process group has {comm.world()}")
    return n


class RankMapper(Mapper):
    """A ``Mapper`` on one of several ranks, whatever cuts its work
    (``DataParallelMapper`` here, ``prefix_shard.PrefixShardedMapper``,
    which sets ``n_ranks`` and ``rank`` and defines ``select``): the
    collective feed loop with checkpoints, the multi-process checkpoint
    (``ckpt_mp.py``) and its agreed restore, the FLD histograms summed,
    ``finalize``'s gather over the ranks, and rank 0's stage snapshots
    broadcast (``from_rank0``)."""

    from_rank0 = staticmethod(comm.broadcast_from0)

    def _reset(self) -> None:
        super()._reset()
        # a restored checkpoint's cursor, the one to save again when the
        # stream has nothing after it, and the step of its last save
        self.restored_cursor = None
        self._ckpt_step = 0

    def fld_histogram(self) -> np.ndarray:
        """The ranks' FLD histograms summed (collective; a rank without an
        estimator adds zeros)."""
        local = (np.zeros(MAX_LEN + 1, np.int64) if self.fld is None
                 else self.fld.hist.cpu().numpy().astype(np.int64))
        return comm.allreduce(local)

    def fld_estimate(self) -> Optional[Tuple[float, float, int]]:
        """The estimate from the ranks' histograms summed (collective)."""
        if not self.estimate_fld:
            return None
        return estimate_from_hist(self.fld_histogram())

    def _gather(self, sigs: np.ndarray, counts: np.ndarray,
                counters: List[int]):
        return (np.concatenate(comm.allgather_rows(sigs)),
                np.concatenate(comm.allgather_rows(counts)),
                [int(v) for v in comm.allreduce(np.asarray(counters,
                                                           np.int64))])

    def run(self, batches: Iterable[ReadBatch],
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 50) -> MapResult:
        """The feed loop; with ``checkpoint_path`` the JAX package's
        collective one. A save is collective, and ranks may hold different
        numbers of batches, so the loop itself is collective: every rank
        joins one all-gather a round (one of its batches a round while it
        has any) with (done, has a cursor). Saves fall due on the round
        count and happen only when every rank offers a cursor (a rank that
        is done offers its last one, or the one it resumed from); every
        rank leaves in the same round."""
        if not checkpoint_path:
            return super().run(batches)
        it = iter(batches)
        rounds = 0
        due = done = warned = False
        last_cursor = self.restored_cursor
        while True:
            batch = None if done else next(it, None)
            if batch is None:
                done = True
                cur = last_cursor
            else:
                self.feed(batch)
                cur = batch.cursor
                if cur is not None:
                    last_cursor = cur
            rounds += 1
            # a rank that never saw a cursor offers none: saving it as
            # "start fresh" on top of a table that holds its reads would
            # count them twice
            flags = comm.allgather(np.asarray([done, cur is not None],
                                              np.int64))
            if flags[:, 0].all():
                break
            due = due or rounds % checkpoint_every == 0
            if due and flags[:, 1].all():
                self.save_checkpoint(checkpoint_path, stream_state=cur)
                due = False
            elif due and not warned:
                log.warning(
                    "periodic checkpoint is blocked: rank(s) %s offered no "
                    "resume cursor this round; saves happen when every rank "
                    "has one, and a final table snapshot is written",
                    np.flatnonzero(flags[:, 1] == 0).tolist())
                warned = True
        self.save_checkpoint(checkpoint_path, stream_state=last_cursor)
        return self.finalize()

    def save_checkpoint(self, path: str,
                        stream_state: Optional[dict] = None) -> None:
        """Collective: every rank calls it at the same round."""
        from .ckpt_mp import save_mapper_checkpoint

        save_mapper_checkpoint(self, path, stream_state)

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        """This rank's part of a multi-process checkpoint (its table, read
        count and FLD state; ``ckpt_mp.py``), agreed by the ranks (the JAX
        package's protocol): a rank holds its restore error until every
        rank has reported, then every rank raises at the same point, so
        none goes on into a later collective alone. Returns the cursor, {}
        when some rank has none (resume is all or nothing: every rank then
        starts fresh), or None when no rank has a checkpoint."""
        from .ckpt_mp import restore_mapper_checkpoint

        state, err = None, None
        try:
            state = restore_mapper_checkpoint(self, path)
        except (ValueError, OSError, KeyError,
                zipfile.BadZipFile) as e:  # raised below, once agreed
            err = e
        cats = comm.allgather(np.asarray(
            [state is None and err is None, bool(state), err is not None],
            np.int64))
        if cats[:, 2].any():
            if err is not None:
                raise err
            bad = np.flatnonzero(cats[:, 2]).tolist()
            raise ValueError(
                f"checkpoint {path} failed to restore on rank(s) "
                f"{bad} (see their errors); delete the checkpoint files to "
                "start fresh")
        if not cats[:, 1].all():
            if not cats[:, 0].all():
                log.warning("checkpoint %s is not resumable on every rank; "
                            "every rank starts fresh", path)
            return None if cats[:, 0].all() else {}
        self.restored_cursor = state
        return state


class DataParallelMapper(RankMapper):
    """A rank's ``Mapper`` that takes its share of the batches and merges
    with the other ranks at ``finalize``."""

    def __init__(self, index: KMerIndex, cfg: MapConfig = MapConfig(),
                 shard: ShardConfig = ShardConfig(), device="cuda",
                 input_share: Optional[Tuple[int, int]] = None,
                 metrics: Optional[Metrics] = None,
                 estimate_fld: bool = False):
        super().__init__(index, cfg, device=device, metrics=metrics,
                         estimate_fld=estimate_fld)
        self.n_ranks = data_ranks(shard)
        self.rank = comm.rank()
        self.place, self.sharers = (input_share if input_share is not None
                                    else (self.rank, self.n_ranks))

    def _reset(self) -> None:
        super()._reset()
        # the global index of the next batch (a cursor's "batch"), from
        # which rank_batches deals
        self.first_batch = 0

    def select(self, batches: Iterable[ReadBatch]) -> Iterator[ReadBatch]:
        """This rank's batches of the stream it reads."""
        return rank_batches(batches, self.place, self.sharers,
                            self.first_batch)

    @property
    def fld_batches(self) -> int:
        """The paired batches this rank samples for the FLD: its own among
        the first SAMPLE_BATCHES of the stream it shares."""
        return len(range(self.place, SAMPLE_BATCHES, self.sharers))

    def restore_checkpoint(self, path: str) -> Optional[dict]:
        state = super().restore_checkpoint(path)
        if state:
            self.first_batch = int(state.get("batch", 0))
        return state
