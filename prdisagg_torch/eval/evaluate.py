"""GAN evaluation suite: parity with generate_and_evaluate.py, as the JAX
package's eval/evaluate.py runs it, on the dataset's and generator's device.

Phases (reference line refs in each method):
  1. map grids: real vs generated fraction/precip fields per condition
  2. large-sample statistics: area means, ECDFs, saved sample tensors
  3. daily-cycle boxplots (drawn with phase 2's plots)
  4. free-noise / shared-noise area-mean line plots
  5. conditional-distribution check: the same latents under two conditions,
     per-hour two-sample KS test -> p-value .txt artifacts

Every draw (index rows and latents) comes from one ``torch.Generator`` on
the dataset's device, seeded with ``EvalConfig.seed``.  With a
data-parallel generator (``PretrainedGenerator(mesh=...)``) every rank
runs every phase with the same draws, each forward is split over the ranks
(api/pretrained.py), and rank 0 alone writes the arrays, p-values and
figures.  ``matplotlib``,
``seaborn`` and ``pandas`` are imported only where a phase draws a figure;
each phase that draws takes an argument that turns its figures off.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from prdisagg_torch.api.pretrained import PretrainedGenerator
from prdisagg_torch.core.config import EvalConfig, ExperimentConfig
from prdisagg_torch.data.sampler import DeviceDataset
from prdisagg_torch.ops.stats import ecdf_plot
from prdisagg_torch.utils.watchdog import beat_if_enabled


def daily_cycle_correlation(res: dict) -> float:
    """Headline quality gate: correlation between the generated and real
    mean hourly-fraction cycles of :meth:`Evaluator.sample_statistics`'s
    output (the quantitative form of the reference's daily-cycle boxplot
    comparison, generate_and_evaluate.py:472-502)."""
    return float(np.corrcoef(
        res["amean_fraction_gen"].mean(axis=0),
        res["amean_fraction_real"].mean(axis=0))[0, 1])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class Evaluator:
    def __init__(
        self,
        exp: ExperimentConfig,
        ds_test: DeviceDataset,
        generator: PretrainedGenerator,
        workdir: str = ".",
        epoch: Optional[int] = None,
    ):
        self.exp = exp
        self.cfg: EvalConfig = exp.eval
        self.ds = ds_test
        self.gen = generator
        self.epoch = self.cfg.epoch if epoch is None else epoch
        self.norm_scale = exp.data.norm_scale
        self.params_str = exp.data.params_string()
        self.plotdir = os.path.join(workdir, f"plots_generated_{exp.name}")
        self.datadir = os.path.join(workdir, "data")
        #: whether this process writes the battery's files (rank 0)
        self.primary = generator.mesh is None or generator.mesh.rank == 0
        if self.primary:
            os.makedirs(self.plotdir, exist_ok=True)
            os.makedirs(self.datadir, exist_ok=True)
        self.rng = torch.Generator(device=ds_test.device).manual_seed(
            self.cfg.seed)
        self._latent_dim = generator.cfg.latent_dim

    # ------------------------------------------------------------------
    def _latent(self, n: int) -> torch.Tensor:
        return torch.randn((n, self._latent_dim), generator=self.rng,
                           device=self.ds.device)

    def _sample_reals(self, n: int):
        """(fractions (n,24,nd,nd,1), cond (n,nd,nd,C)) from the test set,
        on its device."""
        return self.ds.sample_real(n, self.rng)

    def _predict(self, latent, cond_batch) -> np.ndarray:
        """(B, 24, nd, nd) fraction fields on the host."""
        return _host(self.gen.predict_fractions(latent, cond_batch)[..., 0])

    def _fakes_for_cond(self, cond: torch.Tensor, n: int,
                        latent: Optional[torch.Tensor] = None) -> np.ndarray:
        if latent is None:
            latent = self._latent(n)
        return self._predict(latent, cond[None].expand(n, *cond.shape))

    def _dsum(self, cond: torch.Tensor) -> np.ndarray:
        """Unnormalized daily-sum map from the (first channel of the) cond."""
        return _host(cond[..., 0]) * self.norm_scale

    # ------------------------------------------------------------------
    # Phase 1 — map grids (generate_and_evaluate.py:204-387)
    # ------------------------------------------------------------------
    def map_grids(self, n_conditions: Optional[int] = None,
                  n_fake_per_real: Optional[int] = None, save: bool = True):
        n_conditions = n_conditions or self.cfg.n_map_conditions
        n_fake = n_fake_per_real or self.cfg.n_fake_per_real
        reals, conds = self._sample_reals(n_conditions)
        reals = _host(reals[..., 0])

        for i in range(n_conditions):
            beat_if_enabled()  # liveness for a supervisor (~100 figures)
            plotcount = i + 1
            generated = self._fakes_for_cond(conds[i], n_fake)
            if save and self.primary:
                self._save_map_grid(reals[i], generated, self._dsum(conds[i]),
                                    plotcount)

    def _save_map_grid(self, real, generated, dsum, plotcount: int) -> None:
        from prdisagg_torch.utils import plotting

        real_scaled = real * dsum[None]
        np.save(os.path.join(self.datadir,
                             f"real_precip_for_mapplots_{plotcount}.npy"),
                real_scaled)
        for fractions, fields_r, fields_g in (
                (True, real, generated),
                (False, real_scaled, generated * dsum[None, None])):
            kind = "fractions" if fractions else "precip"
            for every, suffix in ((1, "_allhours"), (3, "")):
                fig = plotting.map_comparison_grid(
                    fields_r, fields_g, dsum, fractions=fractions,
                    every=every, fraction_cmap=self.cfg.fraction_cmap)
                fig.savefig(os.path.join(
                    self.plotdir,
                    f"generated_{kind}_{self.params_str}_"
                    f"{self.epoch:04d}_{plotcount:04d}{suffix}."
                    f"{self.cfg.plot_format}"))
            plotting.close_all()

    # ------------------------------------------------------------------
    # Phase 2 — large-sample statistics (generate_and_evaluate.py:390-465)
    # ------------------------------------------------------------------
    def sample_statistics(self, n_samples: Optional[int] = None,
                          chunk: int = 500, save_fields: bool = True,
                          make_plots: bool = True):
        """One generated field per real condition over n_samples draws.

        Returns dict with area-mean arrays (n, 24) and the stored field
        tensors; writes generated_samples.npy / real_samples.npy (inputs to
        the CRPS and LSD stages, generate_and_evaluate.py:428-429).
        """
        n_samples = n_samples or self.cfg.n_stat_samples
        am_frac_gen, am_frac_real, am_gen, am_real = [], [], [], []
        fields_gen, fields_real = [], []

        done = 0
        while done < n_samples:
            b = min(chunk, n_samples - done)
            reals, conds = self._sample_reals(b)
            generated = self._predict(self._latent(b), conds)
            reals = _host(reals[..., 0])
            dsum = self._dsum(conds)

            gen_mm = generated * dsum[:, None]
            real_mm = reals * dsum[:, None]
            am_frac_gen.append(generated.mean(axis=(2, 3)))
            am_frac_real.append(reals.mean(axis=(2, 3)))
            am_gen.append(gen_mm.mean(axis=(2, 3)))
            am_real.append(real_mm.mean(axis=(2, 3)))
            if save_fields:
                fields_gen.append(gen_mm.astype(np.float32))
                fields_real.append(real_mm.astype(np.float32))
            done += b
            beat_if_enabled()

        res = {
            "amean_fraction_gen": np.concatenate(am_frac_gen),
            "amean_fraction_real": np.concatenate(am_frac_real),
            "amean_gen": np.concatenate(am_gen),
            "amean_real": np.concatenate(am_real),
        }
        if save_fields:
            res["generated_samples"] = np.concatenate(fields_gen)
            res["real_samples"] = np.concatenate(fields_real)
        if save_fields and self.primary:
            np.save(os.path.join(self.datadir, "generated_samples.npy"),
                    res["generated_samples"])
            np.save(os.path.join(self.datadir, "real_samples.npy"),
                    res["real_samples"])
        if make_plots and self.primary:
            self._ecdf_plots(res)
            self._daily_cycle(res, n_samples)
        return res

    def _ecdf_plots(self, res):
        from prdisagg_torch.utils.plotting import _pyplot

        _, plt = _pyplot()
        import seaborn as sns

        sns.set_palette("colorblind")
        plt.figure()
        ax1 = plt.subplot(211)
        plt.plot(*ecdf_plot(res["amean_gen"]), label="gen")
        plt.plot(*ecdf_plot(res["amean_real"]), label="real")
        plt.legend(loc="upper left")
        sns.despine()
        plt.xlabel("mm/h")
        plt.ylabel("ecdf areamean")
        plt.semilogx()
        ax2 = plt.subplot(212)
        if "generated_samples" in res:
            plt.plot(*ecdf_plot(res["generated_samples"]), label="gen")
            plt.plot(*ecdf_plot(res["real_samples"]), label="real")
        plt.legend(loc="upper left")
        sns.despine()
        plt.ylabel("ecdf")
        plt.xlabel("mm/h")
        plt.semilogx()
        plt.tight_layout()
        plt.savefig(os.path.join(
            self.plotdir, f"ecdf_allx_{self.params_str}_{self.epoch:04d}.png"
        ), dpi=200)
        ax1.set_xlim(xmin=0.5)
        ax1.set_ylim(ymin=0.8, ymax=1.01)
        ax2.set_xlim(xmin=0.1)
        ax2.set_ylim(ymin=0.6, ymax=1.01)
        plt.savefig(os.path.join(
            self.plotdir, f"ecdf_{self.params_str}_{self.epoch:04d}.png"
        ), dpi=200)
        plt.close("all")

    def _daily_cycle(self, res, n_samples):
        from prdisagg_torch.utils.plotting import _pyplot

        _, plt = _pyplot()
        import pandas as pd
        import seaborn as sns

        frames = []
        for i in range(24):
            frames.append(pd.DataFrame({
                "fraction": res["amean_fraction_gen"][:, i],
                "precip": res["amean_gen"][:, i],
                "typ": "generated", "hour": i + 1,
            }))
            frames.append(pd.DataFrame({
                "fraction": res["amean_fraction_real"][:, i],
                "precip": res["amean_real"][:, i],
                "typ": "real", "hour": i + 1,
            }))
        df = pd.concat(frames)
        df.to_csv(os.path.join(
            self.plotdir,
            f"gen_and_real_ameans_{self.params_str}_{self.epoch:04d}.csv",
        ))
        for showfliers in (True, False):
            plt.figure()
            plt.subplot(211)
            sns.boxplot(x="hour", y="precip", data=df, hue="typ",
                        showfliers=showfliers)
            plt.xlabel("")
            sns.despine()
            plt.subplot(212)
            sns.boxplot(x="hour", y="fraction", data=df, hue="typ",
                        showfliers=showfliers)
            sns.despine()
            plt.suptitle(f"n={n_samples}")
            plt.savefig(os.path.join(
                self.plotdir,
                f"daily_cycle_showfliers{showfliers}_{self.params_str}_"
                f"{self.epoch:04d}.svg",
            ))
        plt.close("all")

    # ------------------------------------------------------------------
    # Phase 4 — line plots (generate_and_evaluate.py:505-546)
    # ------------------------------------------------------------------
    def noise_line_plots(self, n_conditions: Optional[int] = None,
                         n_free: Optional[int] = None,
                         n_shared: Optional[int] = None):
        """Figures only: one line plot per condition of free-noise and
        shared-noise area means against the real field's."""
        from prdisagg_torch.utils.plotting import _pyplot

        _, plt = _pyplot()
        import seaborn as sns

        n_conditions = n_conditions or self.cfg.n_map_conditions
        n_free = n_free or self.cfg.n_line_free_noise
        n_shared = n_shared or self.cfg.n_line_shared_noise
        latent_shared = self._latent(n_shared)
        hours = np.arange(1, 25)
        for isample in range(n_conditions):
            beat_if_enabled()
            reals, conds = self._sample_reals(1)
            real = _host(reals[0, ..., 0])
            cond = conds[0]
            dsum = self._dsum(cond)
            gen_free = self._fakes_for_cond(cond, n_free)
            gen_shared = self._fakes_for_cond(cond, n_shared, latent_shared)

            am_real = (real * dsum[None]).mean(axis=(1, 2))
            am_free = (gen_free * dsum[None, None]).mean(axis=(2, 3))
            am_shared = (gen_shared * dsum[None, None]).mean(axis=(2, 3))
            if not self.primary:
                continue

            plt.figure(figsize=(7, 3))
            plt.plot(hours, am_free.T, label="_nolegend_", alpha=0.3,
                     color="#1b9e77")
            plt.plot(hours, am_shared.T, label="_nolegend_", alpha=1)
            plt.plot(hours, am_real, label="real", color="black")
            plt.xlabel("hour")
            plt.ylabel("precipitation [mm/hour]")
            plt.legend()
            sns.despine()
            plt.savefig(os.path.join(
                self.plotdir,
                f"distribution_lineplot_samenosie_{self.params_str}_"
                f"{self.epoch:04d}_{isample:04d}.svg",
            ))
            plt.close("all")

    # ------------------------------------------------------------------
    # Phase 5 — conditional-distribution KS check
    # (generate_and_evaluate.py:549-604)
    # ------------------------------------------------------------------
    def conditional_distribution_check(
        self, n_pairs: Optional[int] = None,
        n_members: Optional[int] = None, make_plots: bool = True,
    ):
        """Same latent batch under two different conditions; per-hour
        two-sample KS p-values of the generated area-mean fraction
        distributions.  Returns list of (24,) p-value arrays."""
        import scipy.stats

        n_pairs = n_pairs or self.cfg.n_ks_conditions
        n_members = n_members or self.cfg.n_ks_members
        latent = self._latent(n_members)
        all_pvals = []
        for isample in range(n_pairs):
            beat_if_enabled()
            _, cond1 = self._sample_reals(1)
            _, cond2 = self._sample_reals(1)
            gen1 = self._fakes_for_cond(cond1[0], n_members, latent)
            gen2 = self._fakes_for_cond(cond2[0], n_members, latent)
            am1 = gen1.mean(axis=(2, 3))  # (n_members, 24)
            am2 = gen2.mean(axis=(2, 3))
            pvals = np.array([
                scipy.stats.ks_2samp(am1[:, h], am2[:, h]).pvalue
                for h in range(24)
            ])
            all_pvals.append(pvals)
            if not self.primary:
                continue
            np.savetxt(os.path.join(
                self.plotdir,
                f"check_conditional_dist_samenoise_KSpval{self.params_str}_"
                f"{self.epoch:04d}_{isample:04d}.txt",
            ), pvals)
            if make_plots:
                self._ks_boxplots(self._dsum(cond1[0]), self._dsum(cond2[0]),
                                  am1, am2, isample)
        return all_pvals

    def _ks_boxplots(self, dsum1, dsum2, am1, am2, isample):
        from prdisagg_torch.utils.plotting import _pyplot

        _, plt = _pyplot()
        import pandas as pd
        import seaborn as sns
        from matplotlib.colors import LogNorm

        frames = []
        for i in range(24):
            frames.append(pd.DataFrame(
                {"fraction": am1[:, i], "cond": 1, "hour": i + 1}))
            frames.append(pd.DataFrame(
                {"fraction": am2[:, i], "cond": 2, "hour": i + 1}))
        df = pd.concat(frames)
        df.to_csv(os.path.join(
            self.plotdir,
            f"check_conditional_dist_samenoise_{self.params_str}_"
            f"{self.epoch:04d}_{isample:04d}.csv",
        ))
        for showfliers in (True, False):
            fig = plt.figure(constrained_layout=True, figsize=(6, 4.8))
            gs = fig.add_gridspec(2, 2)
            for k, dsum in enumerate((dsum1, dsum2)):
                ax = fig.add_subplot(gs[0, k])
                im = ax.imshow(dsum, cmap="gist_earth_r",
                               norm=LogNorm(vmin=0.01, vmax=50))
                ax.set_title(f"cond {k + 1}")
                ax.axis("off")
                plt.colorbar(im)
            ax3 = fig.add_subplot(gs[1, :])
            sns.boxplot(x="hour", y="fraction", hue="cond", data=df, ax=ax3,
                        showfliers=showfliers)
            sns.despine()
            plt.savefig(os.path.join(
                self.plotdir,
                f"check_conditional_dist_samenoise_showfliers{showfliers}_"
                f"{self.params_str}_{self.epoch:04d}_{isample:04d}.svg",
            ))
        plt.close("all")

    # ------------------------------------------------------------------
    def run_all(self, make_plots: bool = True, **scale_overrides):
        """Full suite at configured scale (override counts for smoke runs).
        With `make_plots` False, phases 1, 2 and 5 write their arrays and
        p-values but no figures, and phase 4, which makes only figures, is
        left out."""
        self.map_grids(
            n_conditions=scale_overrides.get("n_map_conditions"),
            n_fake_per_real=scale_overrides.get("n_fake_per_real"),
            save=make_plots,
        )
        res = self.sample_statistics(
            n_samples=scale_overrides.get("n_stat_samples"),
            make_plots=make_plots,
        )
        if make_plots:
            self.noise_line_plots(
                n_conditions=scale_overrides.get("n_line_conditions"),
                n_free=scale_overrides.get("n_line_free_noise"),
                n_shared=scale_overrides.get("n_line_shared_noise"),
            )
        else:
            print("plots off: phase 4 (noise line plots, figures only) "
                  "left out", flush=True)
        pvals = self.conditional_distribution_check(
            n_pairs=scale_overrides.get("n_ks_conditions"),
            n_members=scale_overrides.get("n_ks_members"),
            make_plots=make_plots,
        )
        return res, pvals
