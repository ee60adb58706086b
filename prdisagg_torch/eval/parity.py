"""Statistical-parity harness against the reference's published artifacts
(the JAX package's eval/parity.py, copied: numpy, glob, and pandas and
scipy where a function needs them).

The reference repo ships the trained model's evaluation outputs
(plots_generated_wgancp_pixelnorm*/): per-sample KS p-value .txt files (24
values each) and conditional-distribution CSVs with the generated area-mean
fraction ensembles (2 conditions x 1000 members x 24 hours).  Acceptance for
a retrained model is statistical, not bitwise: this module loads the
reference populations and compares ours with two-sample tests and
tolerance bands.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence

import numpy as np


def load_reference_ks_pvalues(artifact_dir: str) -> np.ndarray:
    """All per-hour KS p-values from check_conditional_dist_*KSpval*.txt
    files -> (n_files, 24)."""
    paths = sorted(glob.glob(os.path.join(
        artifact_dir, "check_conditional_dist_samenoise_KSpval*.txt"
    )))
    if not paths:
        raise FileNotFoundError(f"no KS p-value artifacts in {artifact_dir}")
    return np.stack([np.loadtxt(p) for p in paths])


def load_reference_conditional_fractions(csv_path: str) -> Dict[int, np.ndarray]:
    """One check_conditional_dist_samenoise_*.csv -> {cond: (members, 24)}
    arrays of generated area-mean fractions."""
    import pandas as pd

    df = pd.read_csv(csv_path, index_col=0)
    out = {}
    for cond in sorted(df["cond"].unique()):
        sub = df[df["cond"] == cond]
        hours = sorted(sub["hour"].unique())
        cols = [sub[sub["hour"] == h]["fraction"].to_numpy() for h in hours]
        out[int(cond)] = np.stack(cols, axis=1)
    return out


def ks_pvalue_population_summary(pvals: np.ndarray) -> Dict[str, float]:
    """Summary statistics of a population of per-hour KS p-values."""
    flat = np.asarray(pvals).ravel()
    return {
        "n": int(flat.size),
        "frac_below_0.05": float(np.mean(flat < 0.05)),
        "frac_below_0.5": float(np.mean(flat < 0.5)),
        "median": float(np.median(flat)),
        "min": float(flat.min()),
        "max": float(flat.max()),
    }


def compare_ks_pvalue_populations(
    ours: np.ndarray, reference: np.ndarray
) -> Dict[str, object]:
    """Two-sample KS between our p-value population and the reference's, plus
    both summaries.  A large p_match means our conditional-sensitivity profile
    is statistically indistinguishable from the published model's."""
    import scipy.stats

    ours_f = np.asarray(ours).ravel()
    ref_f = np.asarray(reference).ravel()
    stat, p = scipy.stats.ks_2samp(ours_f, ref_f)
    return {
        "ks_stat": float(stat),
        "p_match": float(p),
        "ours": ks_pvalue_population_summary(ours_f),
        "reference": ks_pvalue_population_summary(ref_f),
    }


def fraction_cycle_from_csvs(csv_paths: Sequence[str]) -> np.ndarray:
    """Mean generated area-mean fraction per hour across reference CSVs ->
    (24,) daily cycle of the published model."""
    cycles: List[np.ndarray] = []
    for p in csv_paths:
        for arr in load_reference_conditional_fractions(p).values():
            cycles.append(arr.mean(axis=0))
    return np.mean(cycles, axis=0)


def parity_report(
    ours_dir: str,
    reference_dir: str,
    out_path: str | None = None,
    ks_p_threshold: float = 0.01,
    cycle_rtol: float = 0.25,
) -> Dict[str, object]:
    """One-command statistical-parity verdict for a trained model.

    Compares the evaluation artifacts in `ours_dir` (written by
    eval.Evaluator — same filenames as the reference's
    generate_and_evaluate.py:581-604 outputs) against the reference's
    published artifact directory (plots_generated_wgancp_pixelnorm*):

    * KS-p-value population match (conditional-sensitivity profile), and
    * generated daily-cycle band check (correlation + relative deviation).

    Returns (and optionally writes as JSON) a dict with both sub-reports and
    an overall ``passes`` flag: the single runnable gate for real-data
    parity.
    """
    ours_pvals = load_reference_ks_pvalues(ours_dir)
    ref_pvals = load_reference_ks_pvalues(reference_dir)
    ks = compare_ks_pvalue_populations(ours_pvals, ref_pvals)

    def _cycle_csvs(d):
        csvs = sorted(glob.glob(os.path.join(
            d, "check_conditional_dist_samenoise_*.csv")))
        if not csvs:
            raise FileNotFoundError(
                f"no check_conditional_dist_samenoise_*.csv in {d} "
                "(run the evaluator with make_plots=True)")
        return csvs

    cycle_ours = fraction_cycle_from_csvs(_cycle_csvs(ours_dir))
    cycle_ref = fraction_cycle_from_csvs(_cycle_csvs(reference_dir))
    cycle = daily_cycle_band_check(cycle_ours, cycle_ref, rtol=cycle_rtol)

    report = {
        "ours_dir": ours_dir,
        "reference_dir": reference_dir,
        "ks_population": ks,
        "ks_p_threshold": ks_p_threshold,
        "daily_cycle": cycle,
        "passes": bool(ks["p_match"] > ks_p_threshold and cycle["passes"]),
    }
    if out_path:
        import json

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
    return report


def daily_cycle_band_check(
    ours: np.ndarray, reference: np.ndarray, rtol: float = 0.25
) -> Dict[str, object]:
    """Compare hourly fraction cycles (24,): correlation + max relative
    deviation, with a pass flag at the given tolerance."""
    ours = np.asarray(ours, dtype=np.float64)
    reference = np.asarray(reference, dtype=np.float64)
    corr = float(np.corrcoef(ours, reference)[0, 1])
    rel = np.abs(ours - reference) / np.maximum(np.abs(reference), 1e-9)
    return {
        "correlation": corr,
        "max_rel_dev": float(rel.max()),
        "passes": bool(corr > 0.9 and rel.max() < rtol),
    }
