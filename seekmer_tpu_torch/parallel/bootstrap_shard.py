"""Bootstrap replicates sharded over ranks; counterpart of
``seekmer_tpu/parallel/bootstrap_shard.py``.

``bootstrap_on_ranks`` is the quantifier's one entry: it shards the
replicates where the ranks divide ``bootstrap_samples`` and runs the
one-card bootstrap on every rank otherwise, as the JAX package does. Rank
r draws its B / N replicates with a ``torch.Generator`` on its device
seeded ``rank_seed(bootstrap_seed, r)``, so results are reproducible for
a fixed number of ranks and a resumed run draws the same matrix. (The JAX
package folds the rank into its key, ``fold_in(key, d)``, whose bits
torch cannot reproduce; the two packages agree in distribution only, as
``em/bootstrap.resample_counts`` says.)

Each rank runs ``batched_em`` on its replicates through A3, a
``check_every`` block a launch, and the ranks stop together by the JAX
package's rule (``_global_step``): the run stops when every rank's own
``convergence_check`` passes, one all-reduce a block. So each rank's
replicates have the bits of one card's ``batched_em`` on the gathered
(B, E) count matrix (that test on all of alpha passes exactly when it
passes on every rank's part). The replicates are gathered to (B, T) in
rank order. The dense route (K4) is not taken here, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import EMConfig
from ..em import bootstrap as one_card
from ..em import em as em_mod
from ..em.bootstrap import batched_em, resample_counts
from ..em.em import ECTable, convergence_check
from ..utils.metrics import Metrics
from . import comm


class Exchange:
    """The one all-reduce (MAX, float64) of a block: the values a check
    sends, then rank 0's "snapshot due" flag (``em.SYNC_TARGET_S`` after
    the last snapshot, when rank 0 takes snapshots)."""

    def __init__(self, snapshots: bool):
        self.snapshots = snapshots and comm.rank() == 0
        self.last = time.monotonic()
        self.due = False

    def __call__(self, values) -> torch.Tensor:
        due = (self.snapshots and time.monotonic() - self.last
               >= em_mod.SYNC_TARGET_S)
        local = torch.cat([torch.stack([v.to(torch.float64).cpu()
                                        for v in values]),
                           torch.tensor([float(due)], dtype=torch.float64)])
        out = comm.allreduce(local, "max")
        self.due = bool(out[-1] > 0)
        if self.due:
            self.last = time.monotonic()
        return out[:-1]


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s resample: ``seed * 65536 + rank``."""
    if not 0 <= rank < 65536:
        raise ValueError(f"rank {rank} out of range")
    return seed * 65536 + rank


def rank_resample(ec: ECTable, cfg: EMConfig, rank: int,
                  ranks: int) -> torch.Tensor:
    """Rank ``rank``'s (B / N, E) float32 count matrix."""
    gen = torch.Generator(device=ec.counts.device)
    gen.manual_seed(rank_seed(cfg.bootstrap_seed, rank))
    return resample_counts(ec.counts.to(torch.float32),
                           cfg.bootstrap_samples // ranks, gen)


def run_bootstrap_sharded(ec: ECTable, lengths, cfg: EMConfig,
                          alpha_init=None, it_init: int = 0,
                          on_sync: Optional[Callable] = None,
                          metrics: Optional[Metrics] = None
                          ) -> Tuple[torch.Tensor, int]:
    """Returns (est_counts float32 [B, T] on every rank, iterations).

    ``alpha_init`` ((T, B), replicate-major, the whole run's) and
    ``it_init`` warm-start from a bootstrap snapshot; ``on_sync(alpha_TB_np,
    it)``, given on rank 0, receives the gathered (T, B) iterate about
    every ``em.SYNC_TARGET_S`` seconds (pass it on rank 0 only). The
    rank's resample is the span ``resample`` of ``metrics``."""
    rank, ranks = comm.rank(), comm.world()
    B = cfg.bootstrap_samples
    if B % ranks:
        raise ValueError(f"bootstrap_samples {B} not divisible by {ranks} "
                         "ranks")
    local = B // ranks
    with (metrics if metrics is not None else Metrics()).span("resample"):
        cmat = rank_resample(ec, cfg, rank, ranks)
    a_init = (None if alpha_init is None else
              np.asarray(alpha_init)[:, rank * local:(rank + 1) * local])
    exchange = Exchange(snapshots=on_sync is not None)

    def check(alpha_m, alpha_new) -> bool:
        ok = convergence_check(alpha_m, alpha_new, cfg)
        (failed,) = exchange([~ok])
        return not bool(failed > 0)

    def whole(alpha_local: torch.Tensor) -> torch.Tensor:
        """(T, B / N) parts -> (T, B), replicates in rank order."""
        parts = comm.allgather(alpha_local.contiguous())
        return torch.cat(list(parts), dim=1)

    def hook(alpha, it):
        if exchange.due:
            full = whole(alpha)
            if on_sync is not None:
                on_sync(full.cpu().numpy(), it)

    alpha, it = batched_em(cmat, ec.ec_ids, ec.txp_ids, lengths, ec.num_ecs,
                           ec.num_transcripts, cfg, alpha_init=a_init,
                           it_init=it_init, on_sync=hook, check=check)
    return whole(alpha.t()).t(), it


def bootstrap_on_ranks(ec: ECTable, lengths, cfg: EMConfig, ranks: int,
                       alpha_init=None, it_init: int = 0,
                       on_sync: Optional[Callable] = None,
                       metrics: Optional[Metrics] = None
                       ) -> Tuple[torch.Tensor, int]:
    """The bootstrap of a run on ``ranks`` ranks: ``run_bootstrap_sharded``
    where they divide ``bootstrap_samples``, else the one-card
    ``em/bootstrap.run_bootstrap`` on every rank in full."""
    if ranks > 1 and cfg.bootstrap_samples % ranks == 0:
        return run_bootstrap_sharded(ec, lengths, cfg, alpha_init, it_init,
                                     on_sync, metrics)
    return one_card.run_bootstrap(ec, lengths, cfg, alpha_init, it_init,
                                  on_sync, metrics)
