"""What decides ``correct``: each sample the window quantified, held
against the plain reference (``reference/``) number by number, each
number beside its limit from the configuration file.

The numbers, worst over the window's samples:

- ``fragments``, ``mapped``, ``outputs``: exact. The sample's fragments,
  the fragments with a non-empty equivalence class, and the rows of the
  written ``abundance.tsv`` (one a transcript).
- ``comp_mass``: the largest gap, in fragments, between a connected
  component's summed est_counts and the fragments whose class lies in it.
  EM keeps each component's mass, so this holds the mapping to the
  reference class by class up to components, whatever EM did inside.
- ``est_gap``: the largest |est - ref| / (ref + 1) over transcripts,
  ref being float64 EM run for the program's own number of steps, with
  the program's fragment-length estimate where it makes one.
- ``conv_gap``: as ``est_gap``, against float64 EM run to the
  configuration's own stopping rule, with the program's fragment-length
  estimate (the estimate itself is not compared: see PERF.md): a program
  that stops early or converges elsewhere reads high here however exact
  its arithmetic.
- ``boot_int``: the largest distance of a bootstrap replicate's component
  mass from a whole number (a replicate is EM on resampled fragment
  counts, which keeps every component's mass a whole number of
  fragments); ``boot_total``: exact, the replicates' rounded masses must
  sum to the mapped fragments.
- ``boot_var``: |V / W - 1|, V the variance over the replicates of each
  component's mass, summed over components, W what a multinomial resample
  of the sample's N mapped fragments gives, the sum of N p (1 - p) with p
  the component's share of the reference's fragments. A resample skipped
  (every replicate the point estimate) reads 1.
- ``boot_mean``: how far the replicates' mean allocation within each
  component lies from the point estimate's: the sum over transcripts of
  |mean over replicates of x_t / M_c - theta_t / Theta_c|, weighted by the
  component's Theta_c and over the mapped fragments (0 to 2). x and M are
  a replicate's est_counts and component mass, theta and Theta float64 EM
  for the program's own steps. EM keeps the component's mass whatever it
  does inside it, so only this sees a replicate's EM stopped early.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .reference import em as ref_em
from .reference import kmers

EXACT = ("fragments", "mapped", "outputs", "boot_total")


class Reference:
    """The reference's answer for one sample, on ``device``."""

    def __init__(self, table, lanes1, lanes2, lengths: np.ndarray,
                 cfg: dict, device):
        self.device = device
        self.cfg = cfg
        k = cfg["index"]["kmer_length"]
        m = kmers.map_reads(table, lanes1, lanes2, k,
                            cfg["map"]["max_ecs_per_read"])
        self.total = m["total"]
        T = lengths.size
        self.T = T
        ec_off, ec_tids, ec_counts, _ = kmers.resolve(
            table, m["sigs"], m["sig_counts"], T)
        self.mapped = int(ec_counts.sum())
        self.ecs = ref_em.ECs(ec_off, ec_tids, T)
        self.ec_counts = ec_counts
        comp = kmers.components(ec_off, ec_tids, T)
        self.comp = comp
        first = ec_tids[ec_off[:-1]].to(torch.int64)
        self.comp_n = torch.zeros(T, dtype=torch.int64, device=device
                                  ).index_add_(0, comp[first], ec_counts)
        self.fld_hist = m["fld_hist"]
        self.fld = (ref_em.fld_estimate(m["fld_hist"])
                    if cfg["em"]["estimate_fld"] else None)
        self.lengths = torch.as_tensor(lengths, device=device)
        self._em: Dict[tuple, tuple] = {}

    def eff(self, fld) -> torch.Tensor:
        em = self.cfg["em"]
        mean, sd = ((fld[0], fld[1]) if fld is not None
                    else (em["mean_fragment_length"],
                          em["fragment_length_sd"]))
        return ref_em.effective_lengths(self.lengths, mean, sd)

    def em_at(self, steps: Optional[int], fld):
        """float64 EM for exactly ``steps`` steps, or to the stopping rule
        for None: theta."""
        key = (steps, None if fld is None else (fld[0], fld[1]))
        if key not in self._em:
            self._em[key] = ref_em.run(self.ecs, self.ec_counts,
                                       self.eff(fld), self.cfg["em"],
                                       iters=steps)[0]
        return self._em[key]

    def comp_mass(self, x: torch.Tensor) -> torch.Tensor:
        """Component masses of [T] or [B, T] values."""
        x = x.to(self.device, torch.float64)
        if x.dim() == 1:
            return torch.zeros(self.T, dtype=torch.float64,
                               device=self.device).index_add_(0, self.comp, x)
        return torch.zeros((x.shape[0], self.T), dtype=torch.float64,
                           device=self.device).index_add_(1, self.comp, x)


def numbers(out: dict, ref: Reference) -> Dict[str, float]:
    """The numbers of one sample's outputs: ``out`` holds total, mapped,
    est (float [T]), iters, boot ([B, T] or None), fld ((mean, sd, n) or
    None) and rows (lines of abundance.tsv)."""
    cfg = ref.cfg
    em = cfg["em"]
    res = {"fragments": abs(out["total"] - ref.total),
           "mapped": abs(out["mapped"] - ref.mapped),
           "outputs": abs(out["rows"] - ref.T)}
    est = torch.as_tensor(np.asarray(out["est"]), device=ref.device)
    res["comp_mass"] = float((ref.comp_mass(est) - ref.comp_n).abs().max())
    fld = out["fld"] if em["estimate_fld"] else None
    e64 = est.to(torch.float64)
    for name, steps in (("est_gap", int(out["iters"])), ("conv_gap", None)):
        theta = ref.em_at(steps, fld)
        res[name] = float(((e64 - theta).abs() / (theta + 1.0)).max())
    boot = out["boot"]
    if boot is not None:
        x = torch.as_tensor(np.asarray(boot), device=ref.device
                            ).to(torch.float64)
        m = ref.comp_mass(x)
        r = torch.round(m)
        res["boot_int"] = float((m - r).abs().max())
        res["boot_total"] = float((r.sum(dim=1) - ref.mapped).abs().max())
        res["boot_var"] = boot_var(m, ref)
        res["boot_mean"] = boot_mean(x, m, ref.em_at(int(out["iters"]), fld),
                                     ref)
    return res


def boot_var(m: torch.Tensor, ref: Reference) -> float:
    """|V / W - 1| of the replicates' component masses ``m`` [B, T] (see
    the module's docstring)."""
    N = float(ref.mapped)
    p = ref.comp_n.to(torch.float64) / max(N, 1.0)
    W = float((N * p * (1.0 - p)).sum())
    if W <= 0 or m.shape[0] < 2:
        return 0.0
    return abs(float(m.var(dim=0).sum()) / W - 1.0)


def boot_mean(x: torch.Tensor, m: torch.Tensor, theta: torch.Tensor,
              ref: Reference) -> float:
    """The replicates' mean allocation within components against the
    point estimate ``theta`` (see the module's docstring); ``x`` [B, T]
    est_counts, ``m`` their component masses by component id."""
    comp = ref.comp
    M = m[:, comp]
    f = torch.where(M > 0, x / torch.where(M > 0, M, 1.0),
                    torch.zeros_like(x)).mean(dim=0)
    Th = ref.comp_mass(theta)[comp]
    phi = torch.where(Th > 0, theta / torch.where(Th > 0, Th, 1.0),
                      torch.zeros_like(theta))
    return float(((f - phi).abs() * Th).sum() / max(float(ref.mapped), 1.0))


def judge(outs: List[dict], ref: Reference, limits: Dict[str, float]):
    """(worst value of each number over the samples, samples failed)."""
    worst: Dict[str, float] = {}
    failed = 0
    for out in outs:
        nums = numbers(out, ref)
        bad = False
        for name, v in nums.items():
            worst[name] = max(worst.get(name, -math.inf), v)
            if not v <= limit_of(name, limits):
                bad = True
        failed += bad
    return worst, failed


def limit_of(name: str, limits: Dict[str, float]) -> float:
    if name in EXACT:
        return 0.0
    lim = limits.get(name)
    return math.inf if lim is None else float(lim)


def check_lines(worst: Dict[str, float], limits: Dict[str, float]):
    """Each number with its limit, for the last lines and the result."""
    return {name: {"value": v, "limit": (None if name not in EXACT and
                                         limits.get(name) is None
                                         else limit_of(name, limits))}
            for name, v in sorted(worst.items())}


def any_unset(worst: Dict[str, float], limits: Dict[str, float]
              ) -> Optional[str]:
    for name in worst:
        if name not in EXACT and limits.get(name) is None:
            return name
    return None
