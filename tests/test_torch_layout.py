"""I1's plain version (``ops/layout_cuda.py``) against the host layout.

``ops/probe.device_table_layout``, which ``tests/test_torch_ops.py`` holds
to the JAX package's, is the reference: the plain in-place layout must
give its bits, and refuse what it refuses with the same message. The
kernel is held to the same reference on the card in
``tests/test_torch_cuda.py`` (``-k layout``). No JAX here.
"""

import re

import numpy as np
import pytest
import torch

from seekmer_tpu_torch.config import IndexConfig
from seekmer_tpu_torch.index.build import build_index_from_seqs
from seekmer_tpu_torch.map.driver import DeviceIndex
from seekmer_tpu_torch.ops import layout_cuda
from seekmer_tpu_torch.ops.probe import device_table_layout
from seekmer_tpu_torch.utils.metrics import Metrics
from seekmer_tpu_torch.utils.simulate import random_transcriptome
from tests.synthetic_buckets import raw_layout_table

torch.set_num_threads(1)

# (bucket, buckets, kind): G = 4 (the tests' and the smoke's small worlds)
# and 32 (the default) in every kind, the other powers of two mixed, and a
# bucket count that leaves a warp's last group of buckets part-filled
CASES = [(G, nb, kind) for G, nb in ((4, 13), (32, 7))
         for kind in ("mixed", "empty", "full", "over_limit")]
CASES += [(1, 9, "mixed"), (2, 11, "mixed"), (8, 6, "mixed"),
          (16, 5, "mixed"), (32, 3, "mixed")]
INDEX_CASES = [(which, part) for which in ("default", "stash")
               for part in ("table", "stash")]


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(5)
    names, seqs = random_transcriptome(
        rng, num_transcripts=60, min_len=150, max_len=800,
        shared_prefix_frac=0.5)
    return {"default": build_index_from_seqs(names, seqs),
            "stash": build_index_from_seqs(names, seqs,
                                           cfg=IndexConfig(bucket_size=4))}


def _raw(case, indexes):
    if case[0] in ("default", "stash"):
        index = indexes[case[0]]
        return np.array(getattr(index, case[1])), index.bucket, "index"
    G, nb, kind = case
    return raw_layout_table(G, nb, kind, seed=100 * G + nb), G, kind


@pytest.mark.parametrize("case", CASES + INDEX_CASES, ids=str)
def test_plain_layout_equals_host_layout(case, indexes):
    """Bit for bit ``device_table_layout``'s, in the tensor's own bytes;
    an EC id past the packed lane refused with its message, before any
    write."""
    raw, G, kind = _raw(case, indexes)
    t = torch.from_numpy(raw.copy())
    if kind == "over_limit":
        with pytest.raises(ValueError) as want:
            device_table_layout(raw, G)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            layout_cuda.plain(t, G)
        assert torch.equal(t, torch.from_numpy(raw))
        return
    want = device_table_layout(raw, G)
    got = layout_cuda.plain(t, G)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.data_ptr() == t.data_ptr()
    np.testing.assert_array_equal(got.numpy(), want)


def test_layout_table_on_cpu_tensors_takes_the_plain_version():
    """Several tables in one call, each rewritten in place; the CPU
    launches no kernel."""
    raws = [raw_layout_table(4, 13, "mixed", seed=1),
            raw_layout_table(4, 3, "full", seed=2)]
    tensors = [torch.from_numpy(r.copy()) for r in raws]
    before = layout_cuda.layout_table.launches
    got = layout_cuda.layout_table(*tensors, bucket=4)
    assert layout_cuda.layout_table.launches == before
    for g, t, r in zip(got, tensors, raws):
        assert g.data_ptr() == t.data_ptr()
        np.testing.assert_array_equal(g.numpy(), device_table_layout(r, 4))


@pytest.mark.parametrize("bucket,shape", [(3, (12, 4)), (64, (64, 4)),
                                          (0, (4, 4)), (4, (10, 4)),
                                          (4, (8, 3))])
def test_layout_table_refuses(bucket, shape):
    """Buckets the kernel does not take, slots that are not whole buckets,
    rows that are not [hi, lo, ec, aux]: raised, never laid out."""
    t = torch.full(shape, -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        layout_cuda.layout_table(t, bucket=bucket)


def test_from_host_on_the_cpu_lays_out_on_the_host(indexes):
    """The CPU path is the host layout: equal tables, the host index left
    as it was, the EC CSR beside them, the same upload bytes, both spans,
    and no ``index_layout_on_device``."""
    index = indexes["stash"]
    before = index.table.copy()
    metrics = Metrics()
    di = DeviceIndex.from_host(index, "cpu", metrics)
    np.testing.assert_array_equal(
        di.table.numpy(), device_table_layout(index.table, index.bucket))
    np.testing.assert_array_equal(
        di.stash.numpy(), device_table_layout(index.stash, index.bucket))
    np.testing.assert_array_equal(index.table, before)
    t = metrics.snapshot()
    for got, raw in zip(di.ec_csr, (index.ec_offsets, index.ec_transcripts)):
        np.testing.assert_array_equal(got.numpy(), raw)
    assert t["index_upload_bytes"] == sum(
        a.nbytes for a in (index.table, index.stash, index.ec_offsets,
                           index.ec_transcripts))
    assert "index_layout_s" in t and "index_upload_s" in t
    assert "index_layout_on_device" not in t
