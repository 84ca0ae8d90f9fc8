"""K2: the whole k-mer lookup in one kernel (``csrc/probe.cu``).

Replaces ``seekmer_tpu/ops/probe_pallas.py`` ``_match_kernel`` (through
``_bucket_match_pallas``, ``make_bucket_lookup``, ``lookup_ecs_aux_pallas``
and ``lookup_ecs_pallas``). The JAX form is shaped by what Mosaic could not
do: the transposed ``(128, NC)`` lane layout, the masked-reduction column
extraction, the ``(N, 128)`` gathered rows round-tripping device memory,
and the block-compacted stash rounds of ``probe._lookup_flat``. The kernel
drops all of it. A warp owns 32 consecutive lanes: each lane hashes its own
key, the warp loads the hi slabs of its 32 home rows in 16-byte vectors
with all loads in flight before any compare, decides from them which slots
match the key's hi and whether the row has an empty slot, and reads lo and
ecaux only of the hi-matching slots; a key absent from a full row probes
its stash row the same way. It is bounded by random row reads from a table
far larger than L2.
"""

from __future__ import annotations

import torch

from . import _build
from .probe import AUX_BITS, lookup_ecs_aux as plain


def lookup_ecs_aux(hi, lo, valid, table, main_slots: int, stash,
                   stash_slots: int, bucket: int):
    """(hi, lo, valid) lanes of any shape -> (ec, aux) int32, equal to
    ``probe.lookup_ecs_aux``. CPU tensors take the plain version; CUDA
    tensors the kernel."""
    if hi.device.type == "cpu":
        return plain(hi, lo, valid, table, main_slots, stash, stash_slots,
                     bucket)
    if not 1 <= bucket <= 32 or bucket & (bucket - 1):
        raise ValueError(f"the lookup kernel takes buckets of a power of two "
                         f"<= 32 slots, got {bucket}")
    if table.shape[1] != 4 * bucket or stash.shape[1] != 4 * bucket:
        raise ValueError("tables must be in the (n_buckets, 4*bucket) slab "
                         "layout (probe.device_table_layout)")
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise ValueError("hi and lo must be int32")
    shape = hi.shape
    hi_f = hi.reshape(-1)
    lo_f = lo.reshape(-1)
    v_f = valid.reshape(-1).to(torch.bool)
    _build.require_cuda("lookup_ecs_aux", hi_f, lo_f, v_f, table, stash)
    if table.data_ptr() % 16 or stash.data_ptr() % 16:
        raise ValueError("tables must start on a 16-byte boundary (the "
                         "kernel reads their rows as 16-byte vectors)")
    N = hi_f.shape[0]
    ec = torch.empty(N, dtype=torch.int32, device=hi.device)
    aux = torch.empty_like(ec)
    fn = _build.function("seekmer_lookup", 8, 6)
    _build.check(fn(hi_f.data_ptr(), lo_f.data_ptr(), v_f.data_ptr(),
                    table.data_ptr(), stash.data_ptr(), ec.data_ptr(),
                    aux.data_ptr(), _build.stream_of(hi), hi.device.index, N,
                    main_slots // bucket, stash_slots // bucket, bucket,
                    AUX_BITS),
                 "lookup")
    lookup_ecs_aux.launches += 1
    return ec.reshape(shape), aux.reshape(shape)


lookup_ecs_aux.launches = 0


def lookup_ecs(hi, lo, valid, table, main_slots: int, stash,
               stash_slots: int, bucket: int):
    """k-mer lanes -> EC ids (MISS = -1 for absent or invalid lanes)."""
    return lookup_ecs_aux(hi, lo, valid, table, main_slots, stash,
                          stash_slots, bucket)[0]
