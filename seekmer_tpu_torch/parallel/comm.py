"""Process groups of the multi-GPU port: one process ("rank") a card over
``torch.distributed``; counterpart of ``seekmer_tpu/parallel/mesh.py``.

The JAX package builds a device mesh (``make_mesh``: ``jax.sharding.Mesh``
with ``NamedSharding`` and ``shard_map``) inside one process a host and
joins hosts with ``jax.distributed``. Here one rank drives one card, so
there is no mesh: a rank's work is the single-card code on its own card,
and the ranks meet only in the few collectives of this module.

- ``init_distributed`` joins the group ``torchrun`` describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
- ``launch`` starts N ranks on one host itself (``spawn``, a ``file://``
  rendezvous in a temporary directory), joins them, kills the others when
  one fails or the deadline passes, and returns each rank's result; a rank
  exits when its parent does;
- the collectives: ``allreduce``, ``allgather`` (equal shapes),
  ``allgather_rows`` (row counts that differ), ``gather_to0``,
  ``broadcast_from0`` and ``barrier``. Each takes a
  tensor or a numpy array and gives back the same kind, on the same device.

NCCL serves CUDA ranks, gloo CPU ranks (the CPU tests) and several ranks on
one card (NCCL refuses two ranks on one GPU; ``chip_smoke.py`` runs two on
its one card). Under gloo every collective copies its tensor to the host,
runs there and copies the result back: explicitly, here, for every tensor,
so the same code runs whatever gloo's CUDA support covers. NCCL is never
replaced by gloo behind the caller's back: the backend is the caller's
choice or follows the devices. Every collective is bounded by the group's
timeout (``init_process_group(timeout=...)``), so a rank that skips a
collective turns into an error on the others, not a hang.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# Seconds a collective may wait for the other ranks before it raises. A
# rank waits in a collective while another maps more batches, writes a
# checkpoint or resolves, so the bound is generous.
COLLECTIVE_TIMEOUT_S = 1800.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class RankFailed(RuntimeError):
    """A rank started by ``launch`` raised, died or overran the deadline;
    the message carries its traceback where it wrote one."""


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _join(rank_: int, size: int, device: torch.device, backend: str,
          init_method: str, timeout_s: float) -> None:
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL needs a CUDA device, not {device}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank_, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s))


def init_distributed(backend: Optional[str] = None, device="cuda",
                     timeout_s: float = COLLECTIVE_TIMEOUT_S) -> torch.device:
    """Join the process group that ``torchrun`` describes in the
    environment and return this rank's device: ``cuda:LOCAL_RANK`` for
    ``device="cuda"``, else ``device`` itself. A group that is already up
    (a caller's own, or ``launch``'s) is used as it is."""
    dev = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if dev.type == "cuda" and dev.index is None:
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but this host has "
                f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        return dev
    for key in ("RANK", "WORLD_SIZE"):
        if key not in os.environ:
            raise RuntimeError(f"--distributed needs {key} in the "
                               "environment (run under torchrun)")
    _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), dev,
          backend or default_backend(dev), "env://", timeout_s)
    return dev


# ---- the launcher ---------------------------------------------------------


def _watch_parent(parent: int) -> None:
    """Exit this process as soon as ``parent`` is gone: a rank never
    outlives the process that launched it."""
    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(rank_: int, size: int, init_method: str, device: str,
               backend: str, timeout_s: float, threads: int,
               fn: Callable, args: tuple, out: str, parent: int) -> None:
    """A rank's process: join the group, run ``fn(rank, device, *args)``,
    write ("ok", result) or ("error", traceback) to ``out`` and exit."""
    _watch_parent(parent)
    torch.set_num_threads(threads)
    code = 0
    try:
        dev = torch.device(device)
        _join(rank_, size, dev, backend, init_method, timeout_s)
        res = ("ok", fn(rank_, dev, *args))
    except BaseException:  # reported to the launcher, then exit 1
        res, code = ("error", traceback.format_exc()), 1
    try:
        with open(out + ".tmp", "wb") as fh:
            pickle.dump(res, fh)
        os.replace(out + ".tmp", out)
    except Exception:  # noqa: BLE001 — unpicklable result: say so
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    if code == 0:
        dist.destroy_process_group()
    # no interpreter teardown: a failed rank's peers may still be inside a
    # collective, and the launcher kills them
    os._exit(code)


def _rank_result(path: str):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        return pickle.load(fh)


def launch(n: int, fn: Callable, args: tuple = (),
           devices: Optional[Sequence] = None,
           backend: Optional[str] = None,
           timeout_s: Optional[float] = None,
           collective_timeout_s: float = COLLECTIVE_TIMEOUT_S,
           threads: int = 1) -> List[Any]:
    """Run ``fn(rank, device, *args)`` in ``n`` spawned ranks on
    ``devices`` (one a rank; default all CPU) and return their results in
    rank order. ``fn`` and ``args`` are pickled, so ``fn`` is a function of
    a module the ranks can import. ``backend`` defaults to NCCL on cards
    and gloo on the CPU; ranks that share a card must ask for gloo.

    If a rank raises or dies, the others are killed and ``RankFailed``
    carries its traceback; so it does when ``timeout_s`` passes first.
    Each rank sets ``torch.set_num_threads(threads)``."""
    devices = [torch.device(d) for d in (devices or ["cpu"] * n)]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for {n} ranks")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"ranks on both the CPU and cards: {devices}")
    backend = backend or default_backend(devices[0])
    if backend == "nccl" and len({str(d) for d in devices}) < n:
        raise ValueError("NCCL refuses two ranks on one card; pass "
                         "backend='gloo' to share a card")
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="seekmer_ranks_")
    init = "file://" + os.path.join(work, "rendezvous")
    outs = [os.path.join(work, f"rank{r}.pkl") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(
                target=_rank_main, name=f"seekmer-rank{r}", daemon=True,
                args=(r, n, init, str(devices[r]), backend,
                      collective_timeout_s, threads, fn, args, outs[r],
                      os.getpid()))
            p.start()
            procs.append(p)
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            codes = [p.exitcode for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                # a peer's error follows within moments (its collective
                # broke): give it a second, then report every failure
                for p in procs:
                    p.join(1.0 / n)
                whys = []
                for r, p in enumerate(procs):
                    if p.exitcode in (None, 0):
                        continue
                    res = _rank_result(outs[r])
                    whys.append(f"rank {r} of {n}: " + (
                        res[1] if res is not None and res[0] == "error"
                        else f"exit code {p.exitcode}"))
                raise RankFailed("\n".join(whys))
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise RankFailed(f"{n} ranks did not finish within "
                                 f"{timeout_s} s; killed")
            procs[codes.index(None)].join(0.05)
        results = [_rank_result(o) for o in outs]
        return [res[1] for res in results]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        shutil.rmtree(work, ignore_errors=True)


# ---- collectives ----------------------------------------------------------


def _comm_device() -> torch.device:
    """Where this group's collectives run: the host under gloo, this
    rank's card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _as_tensor(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)), True
    return x, False


def _back(t: torch.Tensor, like: torch.Tensor, was_np: bool):
    return t.cpu().numpy() if was_np else t.to(like.device)


def allreduce(x, op: str = "sum"):
    """Elementwise ``op`` ("sum", "max", "min") of ``x`` over the ranks."""
    t, was_np = _as_tensor(x)
    if world() == 1:
        return x
    buf = t.to(_comm_device(), copy=True).contiguous()
    dist.all_reduce(buf, op=_OPS[op])
    return _back(buf, t, was_np)


def allgather(x):
    """Every rank's ``x`` (equal shapes), stacked in rank order:
    (world, *x.shape)."""
    t, was_np = _as_tensor(x)
    if world() == 1:
        return x[None]
    buf = t.to(_comm_device()).contiguous()
    out = [torch.empty_like(buf) for _ in range(world())]
    dist.all_gather(out, buf)
    return _back(torch.stack(out), t, was_np)


def allgather_rows(a: np.ndarray) -> List[np.ndarray]:
    """Every rank's rows of ``a`` (row counts may differ, the rest of the
    shape may not), in rank order: the counts first, then the rows padded
    to the longest."""
    if world() == 1:
        return [a]
    n = allgather(np.asarray([a.shape[0]], np.int64))[:, 0]
    pad = np.zeros((int(n.max()),) + a.shape[1:], a.dtype)
    pad[:a.shape[0]] = a
    rows = allgather(pad)
    return [rows[r, :int(n[r])] for r in range(world())]


def gather_to0(x):
    """Every rank's ``x`` (equal shapes) stacked on rank 0, in rank order;
    None on the others."""
    t, was_np = _as_tensor(x)
    if world() == 1:
        return x[None]
    buf = t.to(_comm_device()).contiguous()
    out = ([torch.empty_like(buf) for _ in range(world())]
           if rank() == 0 else None)
    dist.gather(buf, out, dst=0)
    return _back(torch.stack(out), t, was_np) if rank() == 0 else None


def broadcast_from0(x):
    """Rank 0's ``x`` on every rank (the others pass a buffer of its shape
    and type)."""
    t, was_np = _as_tensor(x)
    if world() == 1:
        return x
    buf = t.to(_comm_device(), copy=True).contiguous()
    dist.broadcast(buf, src=0)
    return _back(buf, t, was_np)


def barrier() -> None:
    """Wait until every rank is here (a one-element all-reduce, bounded
    by the group's timeout)."""
    allreduce(torch.zeros(1))
