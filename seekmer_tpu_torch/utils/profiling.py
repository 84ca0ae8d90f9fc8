"""Tracing hooks: the port's counterpart of
``seekmer_tpu/utils/profiling.py``. ``maybe_trace`` records a
``torch.profiler`` trace (host ranges, kernels and copies on the card) of
a pipeline run into one Chrome-trace JSON file, where the JAX package took
a ``jax.profiler`` trace; ``annotate`` names a range inside it, and also
an NVTX range once CUDA is initialised."""

from __future__ import annotations

import contextlib
import logging
import os

import torch

log = logging.getLogger(__name__)


def trace_path(trace_dir: str, label: str) -> str:
    return os.path.join(trace_dir, f"{label}.trace.json")


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, label: str = "seekmer"):
    """Trace the body with ``torch.profiler`` (CPU, and CUDA where a card
    is present; ranges of every thread) when ``trace_dir`` is set, and
    write the trace to ``trace_dir/<label>.trace.json`` (Chrome-trace
    JSON: Perfetto or chrome://tracing reads it). A trace that cannot be
    written raises."""
    if not trace_dir:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    out = trace_path(trace_dir, label)
    log.info("profiling '%s' -> %s", label, out)
    # every thread's ranges: ingest and upload run on the prefetch thread
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        with annotate(label):
            yield
    # the profiler logs, and does not raise, when it cannot write: write
    # beside the target, check, then rename (which raises where it fails)
    tmp = out + ".tmp"
    prof.export_chrome_trace(tmp)
    if not os.path.isfile(tmp) or not os.path.getsize(tmp):
        raise OSError(f"the profiler did not write its trace: {out}")
    os.replace(tmp, out)


@contextlib.contextmanager
def annotate(label: str):
    """A named range inside an active trace: a ``record_function`` range,
    and an NVTX range when CUDA is initialised (no cost worth naming when
    nothing traces)."""
    with torch.profiler.record_function(label):
        if torch.cuda.is_initialized():
            with torch.cuda.nvtx.range(label):
                yield
        else:
            yield
