"""The port's prefix-sharded index on the CPU: ranks spawned by
``parallel/comm.launch`` over gloo (one launch of 2 ranks for the map
cases, one of 4 for two layouts, 2 for the checkpoint), each under a hard
deadline, against the JAX package's ``parallel/prefix_shard.py`` on the
conftest's 8 fake devices (a mesh over the first n).

- ``shard_index_by_prefix`` at 2 and 4 shards byte-equal to JAX's, shard
  0's FLD payload too, and ``build_bucket_table``'s placement;
- R1 and R2's plain versions (``ops/route.py``) against numpy: each
  owner's count, round 0's slab and the spill list at a capacity that
  takes three rounds, the later rounds' slabs from the spill list, the
  ECs back in place, and an empty batch;
- ``PrefixShardedMapper``'s merged MapResult and ``extra_routing_rounds``
  equal to JAX ``PrefixShardedMapper``'s: meshes (1, 2) single-end and
  paired, (2, 2) paired, (1, 4) at capacity_factor 0.3 (extra rounds >
  0), sampled routing at probe_sample 16 paired and at capacity_factor
  0.3; the shard-0 FLD estimate equal to JAX's;
- a 2-rank checkpointed run stopped after its first save and resumed;
- ``infer --index-shards 2`` (and ``--data-shards 2``) on the CPU writing
  the one-rank run's ``abundance.tsv``.
"""

import numpy as np
import pytest
import torch

from seekmer_tpu.config import MapConfig as JMapConfig
from seekmer_tpu.config import ShardConfig as JShardConfig
from seekmer_tpu.index.build import build_bucket_table as jbuild_bucket
from seekmer_tpu.index.build import build_index_from_seqs
from seekmer_tpu.io.fastq import batch_read_pairs as jbatch_read_pairs
from seekmer_tpu.io.fastq import batch_reads as jbatch_reads
from seekmer_tpu.ops.hash import hash_kmer as jhash_kmer
from seekmer_tpu.parallel.mesh import make_mesh
from seekmer_tpu.parallel.prefix_shard import PrefixShardedMapper as JPSMapper
from seekmer_tpu.parallel.prefix_shard import \
    shard_index_by_prefix as jshard_index
from seekmer_tpu.utils.simulate import (random_transcriptome, simulate_reads,
                                        write_fastq)
from seekmer_tpu_torch import cli
from seekmer_tpu_torch.config import (EMConfig, MapConfig, PipelineConfig,
                                      ShardConfig)
from seekmer_tpu_torch.index.build import build_bucket_table
from seekmer_tpu_torch.map.fld import estimate_from_hist
from seekmer_tpu_torch.ops import route
from seekmer_tpu_torch.ops.hash import hash_kmer_np
from seekmer_tpu_torch.parallel import comm
from seekmer_tpu_torch.parallel.prefix_shard import (_overflow,
                                                    shard_index_by_prefix)
from tests import torch_parallel_workers as workers
from tests.test_torch_self_contained import port_index

torch.set_num_threads(1)

DEADLINE_S = 240  # a launch that takes longer has hung: killed, failed
B_SE, B_PAIR = 512, 256  # reads, pairs a batch: 2 and 4 batches


@pytest.fixture(scope="module")
def world():
    """tests/test_prefix_shard.py's world (40 transcripts, 1,024
    single-end 96 bp reads) and 1,024 read pairs of it."""
    rng = np.random.default_rng(654)
    names, seqs = random_transcriptome(
        rng, num_transcripts=40, min_len=200, max_len=900,
        shared_prefix_frac=0.5)
    index = build_index_from_seqs(names, seqs)
    sim = simulate_reads(rng, seqs, num_reads=1024, read_len=96,
                         error_rate=0.005)
    pairs = simulate_reads(rng, seqs, num_reads=1024, read_len=96,
                           paired=True, mean_frag=150.0, sd_frag=15.0,
                           error_rate=0.005)
    return (index, [r.encode() for r in sim.reads1],
            [r.encode() for r in pairs.reads1],
            [r.encode() for r in pairs.reads2])


# ---- the shards --------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_shards_byte_equal_to_jax(world, n):
    """Every shard's main table and stash, and shard 0's FLD table and
    payload, byte-equal to the JAX package's; every key in one shard."""
    index = world[0]
    jsdi, jfld = jshard_index(index, n, return_fld_shard0=True)
    got, fld0 = shard_index_by_prefix(port_index(index), n,
                                      return_fld_shard0=True)
    assert (got.main_slots, got.stash_slots, got.bucket, got.k,
            got.n_shards) == (jsdi.main_slots, jsdi.stash_slots,
                              jsdi.bucket, jsdi.k, jsdi.n_shards)
    G = got.bucket
    keys = 0
    for d in range(n):
        np.testing.assert_array_equal(got.table[d], np.asarray(jsdi.table[d]))
        np.testing.assert_array_equal(got.stash[d], np.asarray(jsdi.stash[d]))
        keys += int((got.table[d][:, :G] != -1).sum()
                    + (got.stash[d][:, :G] != -1).sum())
    assert keys == index.num_kmers
    for a, b in zip(fld0, jfld):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert (fld0[1] >= 0).sum() > 0
    # a rank builds its own shard's tables only
    part = shard_index_by_prefix(port_index(index), n, only=[n - 1])
    assert part.table[0] is None and part.stash[0] is None
    assert part.stash_slots == jsdi.stash_slots
    np.testing.assert_array_equal(part.table[n - 1],
                                  np.asarray(jsdi.table[n - 1]))
    np.testing.assert_array_equal(part.stash[n - 1],
                                  np.asarray(jsdi.stash[n - 1]))


def test_build_bucket_table_placement_equal_to_jax(world):
    """``build_bucket_table(return_placement=True)``: table, overflow and
    each placed key's slot as the JAX package's, at a load that
    overflows; without the flag the (table, overflow) pair alone; the
    sharding's overflow mask without a table the same."""
    index = world[0]
    occ = index.table[:, 0] != -1
    hi, lo, ec = index.table[occ, 0], index.table[occ, 1], index.table[occ, 2]
    nb = 1 << max(int(np.log2(hi.size // 16)), 1)  # ~16 keys a bucket of 8
    want = jbuild_bucket(hi, lo, ec, nb, 8, jhash_kmer,
                         return_placement=True)
    got = build_bucket_table(hi, lo, ec, nb, 8, hash_kmer_np,
                             return_placement=True)
    assert want[1].any()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(build_bucket_table(hi, lo, ec, nb, 8, hash_kmer_np)) == 2
    # the overflow alone, as a rank finds it for the shards it does not hold
    np.testing.assert_array_equal(_overflow(hi, lo, nb, 8), want[1])


# ---- R1 and R2's plain versions ------------------------------------------


@pytest.mark.parametrize("rounds", [3, 1])
@pytest.mark.parametrize("N", [3000, 0])
@pytest.mark.parametrize("D", [1, 2, 4])
def test_route_plain_against_numpy(D, N, rounds):
    """owner = the top log2(D) bits of the slot hash; counts per owner;
    ranks in lane order within an owner; at a capacity K of three rounds,
    or of one (K at or above every count, as the ``[ps]`` phase routes),
    round 0's slab (the lanes ranked below K) and the spill list (index,
    owner, rank of every lane ranked K or more, in lane order) as numpy
    places them, each later round's slab from the spill list alone, and
    every lane's EC back in place after the rounds, with every unfilled
    slot poisoned (a lane no slot fills and a sentinel EC, which no lane
    may end up holding); an empty batch only zeroes the counts."""
    rng = np.random.default_rng(D)
    hi = rng.integers(0, 1 << 26, N, dtype=np.int64).astype(np.int32)
    lo = rng.integers(0, 1 << 24, N, dtype=np.int64).astype(np.int32)
    valid = rng.random(N) < 0.8
    h = hash_kmer_np(hi.view(np.uint32), lo.view(np.uint32))
    b = D.bit_length() - 1
    owner = np.where(valid, (h >> np.uint32(32 - b)).astype(np.int64)
                     if b else 0, D)
    want_counts = np.bincount(owner, minlength=D + 1)[:D]
    rank = np.full(N, -1)
    for d in range(D):
        mine = np.flatnonzero(owner == d)
        rank[mine] = np.arange(mine.size)
    most = int(want_counts.max(initial=0))
    K = max(-(-most // rounds), 1)  # rounds == 1: K at or above every count

    def slab(base):
        sel = (owner < D) & (rank >= base) & (rank < base + K)
        ret = np.full(D * K, -1)
        ret[owner[sel] * K + rank[sel] - base] = np.flatnonzero(sel)
        return ret

    t_hi, t_lo = torch.from_numpy(hi), torch.from_numpy(lo)
    *first, counts, spill = route.route_first(t_hi, t_lo,
                                              torch.from_numpy(valid), D, K)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    out = rank >= K
    np.testing.assert_array_equal(
        spill.numpy(), np.stack([np.flatnonzero(out), owner[out], rank[out]]))
    n_spill = int(np.maximum(want_counts - K, 0).sum())
    assert spill.shape == (3, n_spill)
    ec = (hi ^ lo) & 0xFFFF  # an owner's answer: any function of the key
    ecs = torch.full((N,), -1, dtype=torch.int32)
    spare = np.flatnonzero(~valid)
    lane = int(spare[0]) if spare.size else 0  # no slot fills it
    sentinel = -7
    for j in range(rounds):
        base = j * K
        s_hi, s_lo, ret = (first if j == 0 else route.route_spill(
            t_hi, t_lo, spill, n_spill, D, base, K))
        f = route.filled(counts, base, K).numpy()
        want_ret = slab(base)
        np.testing.assert_array_equal(ret.numpy(), want_ret)
        np.testing.assert_array_equal(f, want_ret >= 0)
        np.testing.assert_array_equal(s_hi.numpy()[f], hi[want_ret[f]])
        np.testing.assert_array_equal(s_lo.numpy()[f], lo[want_ret[f]])
        tf = torch.from_numpy(f)
        back = torch.where(tf, (s_hi ^ s_lo) & 0xFFFF, sentinel)
        route.unroute(back, torch.where(tf, ret, lane), counts, base, K, ecs)
        assert not bool((ecs == sentinel).any())
    np.testing.assert_array_equal(ecs.numpy(), np.where(valid, ec, -1))


# ---- routed mapping against the JAX package ----------------------------


def _cases(world):
    """{name: (MapConfig kwargs, (data, index), capacity_factor, paired)}"""
    return {
        "se_1x2": (dict(batch_size=B_SE), (1, 2), 2.0, False),
        "pair_1x2": (dict(batch_size=B_PAIR, paired_end=True), (1, 2), 2.0,
                     True),
        "pair_2x2": (dict(batch_size=B_PAIR, paired_end=True), (2, 2), 2.0,
                     True),
        "se_1x4_cf03": (dict(batch_size=B_SE), (1, 4), 0.3, False),
        "sampled_pair_1x2": (dict(batch_size=B_PAIR, paired_end=True,
                                  probe_sample=16), (1, 2), 2.0, True),
        "sampled_1x2_cf03": (dict(batch_size=B_SE, probe_sample=16), (1, 2),
                             0.3, False),
    }


def _launch(world, names):
    index, reads, r1, r2 = world
    cases = []
    for name in names:
        kw, (d, i), cf, paired = _cases(world)[name]
        cases.append((name, MapConfig(sig_table_bits=12, **kw),
                      ShardConfig(data_axis=d, index_axis=i,
                                  index_mode="prefix"), cf,
                      r1 if paired else reads, r2 if paired else None,
                      paired))
    return comm.launch(cases[0][2].data_axis * cases[0][2].index_axis,
                       workers.ps_suite, (port_index(index), cases),
                       timeout_s=DEADLINE_S)


@pytest.fixture(scope="module")
def ranks2(world):
    return _launch(world, ["se_1x2", "pair_1x2", "sampled_pair_1x2",
                           "sampled_1x2_cf03"])


@pytest.fixture(scope="module")
def ranks4(world):
    return _launch(world, ["pair_2x2", "se_1x4_cf03"])


def _jax_run(world, name):
    """JAX PrefixShardedMapper's MapResult, extra routing rounds and
    shard-0 FLD estimator (fed the first paired global batches)."""
    index, reads, r1, r2 = world
    kw, (d, i), cf, paired = _cases(world)[name]
    jcfg = JMapConfig(sig_table_bits=12, **kw)
    jshard = JShardConfig(data_axis=d, index_axis=i, index_mode="prefix")
    import jax

    mapper = JPSMapper(index, jcfg, jshard,
                       mesh=make_mesh(jshard, jax.devices()[:d * i]),
                       capacity_factor=cf)
    batches = list(jbatch_read_pairs(zip(r1, r2), jcfg) if paired
                   else jbatch_reads(reads, jcfg))
    est = None
    if paired:
        est = mapper.make_fld_estimator()
        for b in batches:
            if est.active:
                est.feed(b)
    res = mapper.run(iter(batches))
    return res, mapper.extra_routing_rounds, est


def _same_result(a, b):
    np.testing.assert_array_equal(a.sigs, b.sigs)
    np.testing.assert_array_equal(a.sig_counts, b.sig_counts)
    assert (a.total_reads, a.mapped, a.overflow, a.collisions) == (
        b.total_reads, b.mapped, b.overflow, b.collisions)


@pytest.mark.parametrize("name", ["se_1x2", "pair_1x2", "sampled_pair_1x2",
                                  "sampled_1x2_cf03", "pair_2x2",
                                  "se_1x4_cf03"])
def test_routed_mapping_equal_to_jax(world, ranks2, ranks4, name):
    """Every rank holds JAX PrefixShardedMapper's merged MapResult and
    extra routing rounds; capacity factor 0.3 on (1, 4) takes extra
    rounds."""
    outs = ranks2 if name in ranks2[0] else ranks4
    want, extra, _ = _jax_run(world, name)
    n_reads = len(world[2] if _cases(world)[name][3] else world[1])
    assert want.total_reads == n_reads and 0 < want.mapped <= n_reads
    for out in outs:
        res, got_extra, _, _ = out[name]
        _same_result(res, want)
        assert got_extra == extra
    if name == "se_1x4_cf03":
        assert extra > 0, "the capacity did not force extra rounds"


@pytest.mark.parametrize("name", ["pair_1x2", "pair_2x2"])
def test_shard0_fld_equal_to_jax(world, ranks2, ranks4, name):
    """The ranks' shard-0 histograms summed equal JAX's estimator fed
    the global batches whole, and so do (mean, sd, samples); the ranks
    sampled different rows."""
    outs = ranks2 if name in ranks2[0] else ranks4
    _, _, est = _jax_run(world, name)
    want = np.asarray(est.hist)
    hists = [out[name][2] for out in outs]
    for out in outs:
        np.testing.assert_array_equal(out[name][3], want)
    np.testing.assert_array_equal(sum(hists), want)
    assert not np.array_equal(hists[0], hists[1])
    got = estimate_from_hist(outs[0][name][3])
    assert got is not None and got == est.estimate()


def test_checkpointed_resume(world, tmp_path):
    """2 ranks, a checkpoint every batch, stopped after the first save
    and resumed: the uninterrupted run's mapped count and est_counts
    bits; both ranks' sidecars hold the one global cursor."""
    index, _, r1, r2 = world
    f1, f2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    write_fastq(f1, [r.decode() for r in r1])
    write_fastq(f2, [r.decode() for r in r2])
    cfg = PipelineConfig().replace(
        map=MapConfig(batch_size=B_PAIR, sig_table_bits=12,
                      paired_end=True),
        em=EMConfig(rel_tol=1e-6),
        shard=ShardConfig(index_axis=2, index_mode="prefix", data_axis=1))
    outs = comm.launch(2, workers.ps_ckpt, (port_index(index), cfg,
                                            (f1, f2), str(tmp_path)),
                       timeout_s=DEADLINE_S)
    for plain, resumed, (cursor, total, step) in outs:
        assert step == 1 and 0 < total < plain.total_reads
        assert resumed.mapped == plain.mapped > 0
        assert resumed.total_reads == plain.total_reads == len(r1)
        np.testing.assert_array_equal(resumed.est_counts, plain.est_counts)
        assert resumed.fld_mean == plain.fld_mean
    np.testing.assert_equal(outs[0][2][0], outs[1][2][0])


# ---- the CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def files(world, tmp_path_factory):
    index, _, r1, r2 = world
    tmp = tmp_path_factory.mktemp("torch_prefix_shard")
    paths = {"idx": str(tmp / "index.npz"), "r1": str(tmp / "r1.fq"),
             "r2": str(tmp / "r2.fq")}
    index.save(paths["idx"])
    write_fastq(paths["r1"], [r.decode() for r in r1])
    write_fastq(paths["r2"], [r.decode() for r in r2])
    return tmp, paths


@pytest.mark.parametrize("argv", [
    ["--index-shards", "2"],
    ["--index-shards", "2", "--data-shards", "2"],
])
def test_cli_index_shards_matches_one_rank(files, argv):
    """infer --index-shards 2 (with --data-shards 2: four ranks) on the
    CPU, paired with the fragment length given, writes the one-rank
    run's abundance.tsv byte for byte."""
    tmp, p = files

    def run(out, *opts):
        return cli.main(["infer", p["idx"], str(tmp / out), p["r1"],
                         "--mates", p["r2"], "--device", "cpu",
                         "--batch-size", str(B_PAIR), "--sig-table-bits",
                         "12", "--fragment-length", "150", "--fragment-sd",
                         "15", *opts])

    one = tmp / "one" / "abundance.tsv"
    if not one.exists():
        assert run("one") == 0
    out = "ps_" + "_".join(argv[1::2])
    assert run(out, *argv) == 0
    assert (tmp / out / "abundance.tsv").read_bytes() == one.read_bytes()
