"""The mapper factory: the one place that decides how a run's mapping is
cut over ranks (``ShardConfig``). One card takes ``map/driver.Mapper``;
several ranks, one process a card (``comm.py``), take a
``DataParallelMapper`` (a rank maps its share of the batches) or, under
the prefix-sharded index, a ``PrefixShardedMapper`` (a rank holds one
shard and maps its rows of every batch). Each answers the Quantifier's
rank questions itself (``Mapper``'s interface)."""

from __future__ import annotations

from typing import Optional, Tuple

from ..config import PipelineConfig
from ..index.store import KMerIndex
from ..map.driver import Mapper
from ..utils.metrics import Metrics
from .data_parallel import DataParallelMapper, data_ranks
from .prefix_shard import PrefixShardedMapper, prefix_ranks


def make_mapper(index: KMerIndex, cfg: PipelineConfig, device,
                input_share: Optional[Tuple[int, int]] = None,
                metrics: Optional[Metrics] = None,
                pack_cache: bool = False) -> Mapper:
    """The mapper of ``index`` that ``cfg.shard`` asks for, sampling the
    FLD where ``cfg.em.estimate_fld`` does. ``input_share``: with several
    ranks, (this rank's place, the number of ranks) among those given the
    same files, which deal that input's batches (``--distributed``: a
    host's ranks); None: every rank of the group reads the whole input.
    ``pack_cache`` (the run feeds the pack cache) on several ranks is
    refused, as the JAX package refuses it."""
    shard = cfg.shard
    prefix = shard.index_mode == "prefix" and shard.index_axis != 1
    if shard.index_axis != 1 and not prefix:
        raise ValueError(f"index_axis {shard.index_axis} takes the "
                         "prefix-sharded index (index_mode='prefix')")
    if prefix:
        ranks = prefix_ranks(shard)
    else:
        ranks = 1 if shard.data_axis == 1 else data_ranks(shard)
    if pack_cache and ranks > 1:
        raise ValueError(
            "--pack-cache takes the single-card mapper (no "
            "--data-shards/--index-shards/--distributed): cached "
            "batches are pre-packed for one card's stream")
    kw = dict(device=device, metrics=metrics,
              estimate_fld=cfg.em.estimate_fld)
    if prefix:
        return PrefixShardedMapper(index, cfg.map, shard,
                                   input_share=input_share, **kw)
    if ranks > 1:
        return DataParallelMapper(index, cfg.map, shard,
                                  input_share=input_share, **kw)
    return Mapper(index, cfg.map, **kw)
