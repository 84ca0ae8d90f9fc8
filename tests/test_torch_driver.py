"""The port's Mapper against the JAX Mapper in the configuration whose map
step runs the Pallas kernels (pack, probe and sig backends "pallas",
interpreted on the CPU). MapResult must be equal exactly: signatures,
counts, total, mapped, overflow and collisions.
"""

import numpy as np
import pytest
import torch

from seekmer_tpu.config import MapConfig
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import batch_read_pairs, batch_reads, pack_batch_2bit
from seekmer_tpu.map.driver import Mapper as JMapper
from seekmer_tpu.utils.simulate import random_transcriptome, simulate_reads
from seekmer_tpu_torch.config import MapConfig as TMapConfig
from seekmer_tpu_torch.map.driver import Mapper, resolve_signatures
from seekmer_tpu.map.driver import resolve_signatures as j_resolve
from tests.test_torch_self_contained import port_config, port_index

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    names, seqs = random_transcriptome(
        rng, num_transcripts=48, min_len=200, max_len=600,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=300, read_len=90, paired=True,
                         mean_frag=180.0, error_rate=0.01)

    def ragged(reads):
        """Mixed lengths (several length buckets) and a few N bases."""
        out = []
        for r in reads:
            r = r[:int(rng.integers(20, len(r) + 1))]
            if rng.random() < 0.1:
                j = int(rng.integers(0, len(r)))
                r = r[:j] + "N" + r[j + 1:]
            out.append(r.encode())
        return out

    return index, ragged(sim.reads1), ragged(sim.reads2)


def _batches(reads1, reads2, cfg, packed):
    if reads2 is None:
        out = list(batch_reads(reads1, cfg))
    else:
        out = list(batch_read_pairs(zip(reads1, reads2), cfg))
    return [pack_batch_2bit(b) for b in out] if packed else out


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
@pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
def test_mapper_matches_jax(world, paired, packed):
    index, r1, r2 = world
    cfg = MapConfig(batch_size=64, sig_table_bits=10, paired_end=paired,
                    pack_backend="pallas", probe_backend="pallas",
                    sig_backend="pallas", collision_audit_every=2)
    mates = r2 if paired else None
    want = JMapper(index, cfg).run(_batches(r1, mates, cfg, packed))
    got = Mapper(port_index(index), port_config(cfg), device="cpu").run(
        _batches(r1, mates, cfg, packed))
    np.testing.assert_array_equal(got.sigs, want.sigs)
    np.testing.assert_array_equal(got.sig_counts, want.sig_counts)
    assert (got.total_reads, got.mapped, got.overflow, got.collisions) == (
        want.total_reads, want.mapped, want.overflow, want.collisions)
    assert got.total_reads == len(r1) and 0 < got.mapped < len(r1)
    # host finalize (copied numpy code) resolves identically
    m_w, c_w, d_w = j_resolve(want, index)
    m_g, c_g, d_g = resolve_signatures(got, port_index(index))
    assert d_g == d_w
    np.testing.assert_array_equal(c_g, c_w)
    for a, b in zip(m_g, m_w):
        np.testing.assert_array_equal(a, b)


def test_mapper_refuses_unported_modes(world):
    """Strided and fusion mode are ported: the Mapper takes both, alone and
    together. What stays refused is what the JAX package refuses: fast mode
    with either (MapConfig), and fusion on single-end reads (a fusion
    signature is one a mate)."""
    index, r1, _ = world
    for kw in (dict(probe_stride=2), dict(paired_end=True, fusion_pairs=True),
               dict(paired_end=True, fusion_pairs=True, probe_stride=4)):
        Mapper(port_index(index), TMapConfig(**kw), device="cpu")
    for kw in (dict(probe_sample=4, probe_stride=2),
               dict(probe_sample=4, paired_end=True, fusion_pairs=True)):
        with pytest.raises(ValueError, match="probe_sample"):
            TMapConfig(**kw)
    cfg = MapConfig(batch_size=64, sig_table_bits=10, fusion_pairs=True)
    with pytest.raises(ValueError, match="paired-end"):
        Mapper(port_index(index), port_config(cfg), device="cpu").run(
            batch_reads(r1[:64], cfg))


def test_mapper_cuda_without_card_raises(world):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    index, _, _ = world
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Mapper(port_index(index), TMapConfig(), device="cuda")


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_complex_reads_counted(world, paired):
    """Dense mode counts the reads past the class cap: at a cap of 1 they
    and the mapped reads are the reads a cap of 64 maps (every read with a
    hit). Fast mode runs K3 without a counter and reports none."""
    index, r1, r2 = world
    mates = r2 if paired else None
    tindex = port_index(index)

    def run(**kw):
        cfg = TMapConfig(batch_size=64, sig_table_bits=10, paired_end=paired,
                         **kw)
        return Mapper(tindex, cfg, device="cpu").run(_batches(
            r1, mates, MapConfig(batch_size=64, paired_end=paired), False))

    capped, wide = run(max_ecs_per_read=1), run(max_ecs_per_read=64)
    assert capped.complex_reads > 0 and wide.complex_reads == 0
    assert capped.mapped + capped.complex_reads == wide.mapped
    assert run(probe_sample=16).complex_reads is None
