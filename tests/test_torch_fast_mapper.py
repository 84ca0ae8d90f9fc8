"""Fast mode: the port's ``Mapper`` against the JAX ``Mapper`` with
``probe_sample`` set, single-end and paired, at strides 2, 4 and 16, and
once with JAX's Pallas backends interpreted. ``MapResult`` must be equal
exactly: signatures, counts, total, mapped, overflow and collisions. (Its
own file so that the test runners spread the JAX compiles of fast mode.)
"""

import numpy as np
import pytest
import torch

from seekmer_tpu.config import MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
from seekmer_tpu_torch.map.driver import Mapper
from tests.test_torch_fast import _batches, _same_result
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def whole_reads():
    """The index and 340 read pairs of 90 bp, 300 simulated with 1% errors
    and a few N bases, 40 junk: one length bucket, so the JAX Mapper
    compiles its step once."""
    rng = np.random.default_rng(43)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=700,
        shared_prefix_frac=0.6)
    sim = simulate_reads(rng, seqs, num_reads=300, read_len=90, paired=True,
                         mean_frag=180.0, error_rate=0.01)

    def with_n(reads):
        out = []
        for r in reads:
            j = int(rng.integers(0, len(r)))
            out.append(r[:j] + "N" + r[j + 1:] if rng.random() < 0.1 else r)
        return out + ["".join(rng.choice(list("ACGT"), size=90))
                      for _ in range(40)]

    return (build_index_from_seqs(names, seqs), with_n(sim.reads1),
            with_n(sim.reads2))


@pytest.mark.parametrize("paired,stride,pallas", [
    (False, 2, False), (False, 4, False), (False, 16, False),
    (True, 2, False), (True, 4, False), (True, 16, False), (False, 4, True),
], ids=["single_s2", "single_s4", "single_s16", "paired_s2", "paired_s4",
        "paired_s16", "single_s4_pallas"])
def test_mapper_fast_matches_jax(whole_reads, paired, stride, pallas):
    """MapResult of the port's Mapper equal to the JAX Mapper's; the
    Pallas case runs JAX's pack, probe and signature kernels interpreted
    (the cap is left at auto, so JAX calibrates it on the first batch)."""
    index, r1, r2 = whole_reads
    kw = (dict(pack_backend="pallas", probe_backend="pallas",
               sig_backend="pallas") if pallas
          else dict(sample_fallback_frac=0.5))
    cfg = MapConfig(batch_size=128, sig_table_bits=10, paired_end=paired,
                    probe_sample=stride, collision_audit_every=2, **kw)
    mates = r2 if paired else None
    want = JMapper(index, cfg).run(_batches(r1, mates, cfg))
    got = Mapper(port_index(index), port_config(cfg), device="cpu").run(
        _batches(r1, mates, cfg))
    _same_result(got, want)
    assert got.total_reads == len(r1) and 0 < got.mapped < len(r1)
