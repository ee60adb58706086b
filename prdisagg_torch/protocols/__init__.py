"""The paper's protocol drivers on the port, one module each (the JAX
package's ``scripts/`` drivers of the same experiments):

  python -m prdisagg_torch.protocols.large_domain [n_days] [epochs] [batch] [chunks] [export_every]
  python -m prdisagg_torch.protocols.variants [n_days] [epochs]
  python -m prdisagg_torch.protocols.epoch_curve MODEL_DIR [epochs ...]
  python -m prdisagg_torch.protocols.paper [--smoke | --mini] [--workdir W] ...
  python -m prdisagg_torch.protocols.paper_finish WORKDIR PEAK_EPOCH CORR KS_FRAC [n_lsd]
  python -m prdisagg_torch.protocols.l1_rehearsal [WORKDIR] [--days N]

Their data is :func:`prdisagg_torch.data.synthetic.make_scale_dataset`.
Each runs on ``--device`` (default ``cuda``).  Per-epoch ``.h5`` exports
need ``h5py`` and figures need ``matplotlib`` (the evaluation's also
``seaborn`` and ``pandas``); where one is missing a driver refuses to
start and names the flag that turns the artifact off (``--export-format
npz``, ``--no-plots``), as ``cli train`` does.  ``--model-preset tiny``
shrinks the networks, in float32, for rehearsals on the CPU.

This module holds what the drivers share.
"""

from __future__ import annotations

import dataclasses
import glob
import os

#: the evaluation's figures need these (cli.py cmd_evaluate)
FIGURE_MODULES = ("matplotlib", "seaborn", "pandas")


def add_run_args(p, plots: bool = True, preset: bool = True) -> None:
    """--device, --export-format, and --no-plots and --model-preset where
    asked for."""
    p.add_argument("--device", default="cuda",
                   help="where the protocol computes (default cuda)")
    p.add_argument("--export-format", dest="export_format", default="h5",
                   choices=["h5", "npz", "both"],
                   help="per-epoch weight exports: the reference's .h5 "
                        "(needs h5py), the JAX package's .npz, or both")
    if preset:
        p.add_argument("--model-preset", dest="model_preset",
                       default="flagship", choices=["flagship", "tiny"],
                       help="tiny = the smoke architecture, for CPU "
                            "rehearsals")
    if plots:
        p.add_argument("--no-plots", dest="no_plots", action="store_true",
                       help="no figures (they need matplotlib, seaborn "
                            "and pandas)")


def refuse_missing(args) -> None:
    """Exit before any work when an artifact the arguments ask for needs a
    package that is not installed, naming the flag that turns it off."""
    from prdisagg_torch.cli import _refuse_missing

    needs = []
    if args.export_format in ("h5", "both"):
        needs.append(("h5py", "the .h5 weight exports",
                      "--export-format npz"))
    if not getattr(args, "no_plots", True):
        needs += [(mod, "the figures", "--no-plots")
                  for mod in FIGURE_MODULES]
    _refuse_missing(needs)


def with_preset(exp, preset: str):
    """`exp` with the smoke architecture in float32 for ``--model-preset
    tiny``."""
    if preset != "tiny":
        return exp
    from prdisagg_torch.core.config import smoke_model_config

    return dataclasses.replace(exp, model_override=smoke_model_config(
        ndomain=exp.data.ndomain, n_cond_channels=exp.data.n_cond_channels,
        compute_dtype="float32"))


def export_ext(export_format: str) -> str:
    """The extension the drivers read exports back in."""
    return "npz" if export_format == "npz" else "h5"


def export_paths(model_dir: str, export_format: str, pattern: str = "gen_*"):
    """Sorted generator exports of one format in a model directory."""
    return sorted(glob.glob(os.path.join(
        model_dir, f"{pattern}.{export_ext(export_format)}")))


def load_export(path: str, device, n_cond_channels: int = 1,
                seed: int = 354):
    """A PretrainedGenerator of one export, .npz or the reference's .h5,
    its architecture inferred from the file."""
    from prdisagg_torch.api.pretrained import PretrainedGenerator

    load = (PretrainedGenerator.from_npz if path.endswith(".npz")
            else PretrainedGenerator.from_keras_h5)
    return load(path, n_cond_channels=n_cond_channels, seed=seed,
                device=device)


class Lines:
    """Summary lines: printed as they come and kept for the summary file."""

    def __init__(self):
        self.lines: list = []

    def __call__(self, s: str) -> None:
        print(s, flush=True)
        self.lines.append(s)

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.lines) + "\n")
