"""Where K4's time goes: section clocks on one card.

    python -m seekmer_tpu_torch.ops.em_profile

Builds ``seekmer_tpu_torch/csrc`` once as shipped and once with
``-DSEEKMER_EM_PROFILE``, runs a fixed 480 iterations of K4 on a random
0/1 membership at the config-1 bootstrap shapes (E 1,396, T 1,000, R 100,
and R 1), and prints microseconds an iteration (CUDA events, mean of three
launches) and, for the profiled build, block 0's clock64 cycles an
iteration by section (``seekmer_em_profile`` in ``csrc/em.cu``). Needs one
NVIDIA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from ..config import EMConfig
from . import _build, em_cuda

SECTIONS = ("gather", "products", "epilogue", "syncs", "group load",
            "grid", "total", "product wait")
VARIANTS = ([], ["-DSEEKMER_EM_PROFILE"])


def system(E, T, R, dev, seed=0):
    rng = np.random.default_rng(seed)
    M = np.zeros((E, T), np.float32)
    for e in range(E):
        M[e, rng.choice(T, size=int(rng.integers(1, 5)), replace=False)] = 1
    M[rng.integers(0, E, size=T), np.arange(T)] = 1
    n = rng.poisson(50.0, size=(R, E)).astype(np.float32)
    inv = (1.0 / rng.uniform(200, 3000, size=T)).astype(np.float32)
    a0 = np.repeat(n.sum(1, keepdims=True) / T, T, 1).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (M, n, inv, a0)]


def main() -> int:
    if not torch.cuda.is_available():
        print("em_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = EMConfig(rel_tol=0.0, min_iters=480, max_iters=480)
    systems = {R: system(1396, 1000, R, dev) for R in (100, 1)}
    base = list(_build.NVCC_FLAGS)
    for extra in VARIANTS:
        _build.NVCC_FLAGS[:] = base + extra
        _build._lib.cache_clear()
        _build.function.cache_clear()
        _build.build()
        for R, sys_ in systems.items():
            def run():
                return em_cuda.em_fixed_point(*sys_, cfg)

            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                run()
            end.record()
            torch.cuda.synchronize()
            us = start.elapsed_time(end) / 3 / 480 * 1e3
            line = f"{' '.join(extra) or 'as shipped'}, R {R}: {us:.3f} us/it"
            if extra:
                prof = _build._lib().seekmer_em_profile
                prof.argtypes = [ctypes.c_void_p]
                buf = (ctypes.c_uint64 * 8)()
                prof(ctypes.addressof(buf))  # zero what the timing added
                run()
                torch.cuda.synchronize()
                prof(ctypes.addressof(buf))
                line += "; cycles/it: " + ", ".join(
                    f"{name} {buf[i] / 480:.0f}"
                    for i, name in enumerate(SECTIONS))
            print(line, flush=True)
    _build.NVCC_FLAGS[:] = base
    return 0


if __name__ == "__main__":
    sys.exit(main())
