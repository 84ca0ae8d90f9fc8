"""``correct`` can come out false: on tiny copies of the cells (CPU, the
program's plain path, the configurations' own limits), a sound run is
correct; the control (the reference in bfloat16 in the program's place)
is not; and a run with the timed path broken underneath is not, once for
each fault a cell can have: a step that returns its state unchanged,
half of each batch left out, an answer altered where it is produced, and
two of the bootstrap's: its resample skipped, and its EM stopped early.
(One card: no exchange between chips to leave out.)"""

import dataclasses


import numpy as np
import pytest
import torch

from gpubench import check, control, manifest, run
from gpubench.tests import tiny

SEED = 2**31 + 77


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("gpubench"))


@pytest.fixture(scope="module")
def cache(root):
    return root.parent / "cache"


def one_run(root, cache, tmp_path, workload="pe"):
    bench = manifest.load_benchmark(root / "BENCHMARK.json")
    return run.run_cell(bench, workload, SEED, 0.5, False, device="cpu",
                        root=root, cache=cache, tmp=tmp_path,
                        log=lambda m: None)


@pytest.mark.parametrize("workload", ["pe", "se", "pec", "fam"])
def test_sound_run_is_correct(root, cache, tmp_path, workload):
    res = one_run(root, cache, tmp_path, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"fragments_per_s", "setup_s"}


@pytest.mark.parametrize("workload", ["pe", "se", "fam"])
def test_control_is_not_correct(root, cache, workload):
    bench = manifest.load_benchmark(root / "BENCHMARK.json")
    cfg = manifest.load_config(manifest.cell(bench, workload)["config"],
                               root)
    for nums in control.run_control(bench, workload, [SEED, 5, 6],
                                    device="cpu", root=root, cache=cache,
                                    log=lambda m: None):
        over = [n for n, v in nums.items()
                if not v <= check.limit_of(n, cfg["limits"])]
        assert over, nums


@pytest.mark.parametrize("fault,number", [("no_resample", "boot_var"),
                                          ("boot_short", "boot_mean")])
def test_planted_reference_fault_is_not_correct(root, cache, fault, number):
    """The faults whose readings on the card bound the bootstrap's limits,
    planted in the float64 reference put in the program's place."""
    bench = manifest.load_benchmark(root / "BENCHMARK.json")
    cfg = manifest.load_config(manifest.cell(bench, "pe")["config"], root)
    for nums in control.run_control(bench, "pe", [SEED, 5], device="cpu",
                                    root=root, cache=cache,
                                    log=lambda m: None, fault=fault):
        assert nums[number] > check.limit_of(number, cfg["limits"]), nums


def _state_unchanged(monkeypatch):
    from seekmer_tpu_torch.ops import em_cuda, em_csr_cuda

    def unchanged(alpha0, counts, scale, layout, cfg, divide, it_init=0):
        return alpha0, cfg.max_iters, False

    def unchanged_dense(m, counts, inv_eff, alpha0, cfg):
        return alpha0, cfg.max_iters

    monkeypatch.setattr(em_csr_cuda, "em_fixed_point", unchanged)
    monkeypatch.setattr(em_cuda, "em_fixed_point", unchanged_dense)


def _half_batch(monkeypatch):
    from seekmer_tpu_torch.map import driver

    real = driver.map_step

    def half(di, cfg, table, codes, lengths, weights, **kw):
        weights = weights.clone()
        weights[weights.shape[0] // 2:] = 0
        return real(di, cfg, table, codes, lengths, weights, **kw)

    monkeypatch.setattr(driver, "map_step", half)


def _answer_altered(monkeypatch):
    from seekmer_tpu_torch.models import quantifier

    real = quantifier.resolve_signatures

    def altered(result, index):
        members, counts, dropped = real(result, index)
        counts = np.array(counts, np.float64)
        counts[0] -= 1
        counts[-1] += 1
        return members, counts, dropped

    monkeypatch.setattr(quantifier, "resolve_signatures", altered)


def _no_resample(monkeypatch):
    from seekmer_tpu_torch.em import bootstrap

    def same(counts, num_samples, generator):
        return counts[None, :].expand(num_samples, -1).contiguous()

    monkeypatch.setattr(bootstrap, "resample_counts", same)


def _boot_short(monkeypatch):
    from seekmer_tpu_torch.models import quantifier

    real = quantifier.run_bootstrap

    def short(ec, lengths, cfg, **kw):
        return real(ec, lengths, dataclasses.replace(
            cfg, max_iters=cfg.check_every), **kw)

    monkeypatch.setattr(quantifier, "run_bootstrap", short)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _no_resample,
                                   _boot_short],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered", "no_resample", "boot_short"])
@pytest.mark.parametrize("workload", ["pe", "se"])
def test_fault_is_not_correct(root, cache, tmp_path, monkeypatch, fault,
                              workload):
    fault(monkeypatch)
    res = one_run(root, cache, tmp_path, workload)
    assert not res["correct"], res["checks"]
    assert res["failed"] == res["attempted"] >= 1


def test_no_card_no_result(monkeypatch, root, cache, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX"):
        monkeypatch.setenv(var, "unused")
    bench = manifest.load_benchmark(root / "BENCHMARK.json")
    with pytest.raises(run.NoCard):
        run.run_cell(bench, "pe", SEED, 0.5, False, device="cuda",
                     root=root, cache=cache, tmp=tmp_path)
    assert run.main(["--workload", "gencode_pe100.b100", "--seed", "1",
                     "--seconds", "1"]) == 2
