"""Multi-process checkpoints of the ranks' mappers (``data_parallel.
RankMapper``: the data-parallel and the prefix-sharded one); counterpart of
``seekmer_tpu/parallel/ckpt_mp.py`` with the JAX package's protocol.

One table file, written by rank 0: every rank's signature table stacked
in rank order along the first axis (the scalar counters as (N,) vectors),
in the npz keys and ``FORMAT`` of a single-process checkpoint
(``utils/checkpoint.py``) with ``total_reads`` -1. Beside it a sidecar a
rank, ``<path>.host<i>.npz``: the rank's cursor, read count and FLD
state. Every file carries the save's ``step``, which rises by one a save;
a restore refuses a sidecar that is missing or of another step (a crash
between the table and the sidecars, or another number of ranks), because
a table of save N with a cursor of save M maps the reads between them
twice or never.

Write order: the table (gathered to rank 0, which writes it), a barrier,
every rank's sidecar, a barrier. A crash before the table's rename leaves
the previous save whole; one after it shows in the steps. Every rank
calls ``save_mapper_checkpoint`` at the same round
(``map/driver._run_with_checkpoints_multiprocess``). The JAX package's
``place_global`` and ``allgather_host`` (placing a host copy under a
``NamedSharding``) have no counterpart: a rank keeps its own table on its
card and slices its own part out of the file.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..map.signature import SigTable
from ..utils.checkpoint import (adapt_ec_count, load_host_cursor,
                                load_map_checkpoint, save_host_cursor,
                                save_map_checkpoint)
from . import comm


def _stacked(gathered: torch.Tensor) -> torch.Tensor:
    """(N, *shape) gathered parts -> the file's layout: concatenated along
    the first axis, a scalar's parts as a (N,) vector."""
    if gathered.dim() == 1:
        return gathered
    return gathered.reshape((-1,) + tuple(gathered.shape[2:]))


def save_mapper_checkpoint(mapper, path: str,
                           stream_state: Optional[dict]) -> None:
    """Collective save of a rank's mapper: the stacked table by
    rank 0, a barrier, each rank's sidecar, a barrier."""
    mapper._ckpt_step += 1
    step = mapper._ckpt_step
    parts = [comm.gather_to0(x) for x in mapper.table]
    if comm.rank() == 0:
        host = SigTable(*(_stacked(p).cpu() for p in parts))
        save_map_checkpoint(path, host, -1, None, step=step)
    del parts
    comm.barrier()
    save_host_cursor(path, comm.rank(), stream_state, mapper.total_reads,
                     step, fld=None if mapper.fld is None
                     else mapper.fld.state())
    comm.barrier()


def _part(x: torch.Tensor, like: torch.Tensor, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of a stacked array whose parts are shaped as
    ``like`` (a scalar's part is its element)."""
    if like.dim() == 0:
        return x[rank]
    n = like.shape[0]
    return x[rank * n:(rank + 1) * n]


def restore_mapper_checkpoint(mapper, path: str) -> Optional[dict]:
    """This rank's table, read count and FLD state from a multi-process
    checkpoint into ``mapper``; returns its cursor ({} without one), or
    None when there is no table file. Raises on a missing or mismatched
    sidecar and on a table of another shape: the caller agrees with the
    other ranks before it raises (``Quantifier``)."""
    loaded = load_map_checkpoint(path, "cpu", with_step=True,
                                 multiprocess=True)
    if loaded is None:
        return None
    table, _, _, _, step = loaded
    rank, n = comm.rank(), mapper.n_ranks
    hc = load_host_cursor(path, rank)
    if hc is None or hc[2] != step:
        raise ValueError(
            f"multi-process checkpoint {path} is inconsistent on rank "
            f"{rank}: sidecar "
            f"{'missing' if hc is None else f'step {hc[2]}'} vs table step "
            f"{step} (a crash during a save, or another number of ranks); "
            "delete the checkpoint files to start fresh")
    if table.count.shape[0] != n * mapper.table.count.shape[0]:
        raise ValueError(
            f"checkpoint {path} holds {table.count.shape[0]} table rows, "
            f"not {n} ranks x {mapper.table.count.shape[0]} "
            "(another number of ranks or sig_table_bits)")
    mine = SigTable(*(_part(x, like, rank).to(mapper.device, copy=True)
                      for x, like in zip(table, mapper.table)))
    mapper.table = adapt_ec_count(mine, mapper.table.ec_count.shape)
    cursor, mapper.total_reads, _, fld = hc
    mapper._ckpt_step = step
    if fld is not None:
        mapper.make_fld_estimator(state=fld)
    return cursor if cursor is not None else {}
