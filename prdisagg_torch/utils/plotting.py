"""Training and evaluation figures (agg backend, the reference's file names).

The sample grid of the reference (gan_train_cwgangp_pixelnorm.py:411-425,
494-508), the loss curves (:511-516) and the evaluation's map grids
(generate_and_evaluate.py:204-387), as the JAX package draws them
(utils/plotting.py there).  ``matplotlib`` is imported inside the
functions: a run that plots nothing does not need it.
"""

from __future__ import annotations

import numpy as np

COND_CMAP = "gist_earth_r"
COND_NORM = dict(vmin=0.01, vmax=1)
PRECIP_NORM = dict(vmin=0.01, vmax=50)


def _pyplot():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def _squeeze(fractions: np.ndarray, cond: np.ndarray):
    """Drop the trailing channel axes: fractions (n, nh, nd, nd), cond
    (n, nd, nd), channel 0."""
    fractions, cond = np.asarray(fractions), np.asarray(cond)
    if fractions.ndim == 5:
        fractions = fractions[..., 0]
    if cond.ndim == 4:
        cond = cond[..., 0]
    return fractions, cond


def sample_grid(fractions: np.ndarray, cond: np.ndarray, title: str = ""):
    """n x 25 subplot grid: column 0 the condition map, then the hourly
    fractions.  fractions: (n, 24, nd, nd[, 1]); cond: (n, nd, nd[, c]).

    Bug for bug with the reference's loop ``for j in range(1, 24)``
    (gan_train_cwgangp_pixelnorm.py:420-423): hour 0 is never drawn and the
    25th column stays empty.  :func:`sample_grid_mosaic`, the per-epoch
    renderer, shows all 24 hours instead."""
    _, plt = _pyplot()
    from matplotlib.colors import LogNorm

    fractions, cond = _squeeze(fractions, cond)
    n_plot = len(fractions)
    fig = plt.figure(figsize=(25, max(n_plot, 2)))
    for i in range(n_plot):
        ax = plt.subplot(n_plot, 25, i * 25 + 1)
        ax.imshow(cond[i], cmap=COND_CMAP, norm=LogNorm(**COND_NORM))
        ax.axis("off")
        for j in range(1, 24):
            ax = plt.subplot(n_plot, 25, i * 25 + j + 1)
            ax.imshow(fractions[i, j], vmin=0, vmax=1, cmap="hot_r")
            ax.axis("off")
    if title:
        fig.suptitle(title)
    return fig


def sample_grid_mosaic(fractions: np.ndarray, cond: np.ndarray, path: str,
                       sep: int = 2) -> None:
    """One row per sample: the condition map, then the hourly fractions
    (all of them; the reference's subplot loop skips hour 0).

    fractions: (n, nh, nd, nd[, 1]); cond: (n, nd, nd[, c]), channel 0
    drawn.  A mosaic with one ``imsave`` instead of n x 25 subplots: the JAX
    package measured the subplot figure at about 30x the cost."""
    matplotlib, plt = _pyplot()
    from matplotlib.colors import LogNorm

    fractions, cond = _squeeze(fractions, cond)
    n, nh = fractions.shape[:2]
    h = fractions.shape[2]
    frac_cmap = matplotlib.colormaps["hot_r"]
    cond_cmap = matplotlib.colormaps[COND_CMAP]
    cond_norm = LogNorm(**COND_NORM, clip=True)
    rows = []
    hsep = np.ones((h, sep, 3), dtype=np.float32)
    for i in range(n):
        panels = [cond_cmap(cond_norm(np.maximum(
            cond[i], COND_NORM["vmin"])))[..., :3]]
        for j in range(nh):
            panels.append(hsep)
            panels.append(frac_cmap(np.clip(fractions[i, j], 0, 1))[..., :3])
        rows.append(np.concatenate(panels, axis=1))
        rows.append(np.ones((sep, rows[-1].shape[1], 3), dtype=np.float32))
    mosaic = np.concatenate(rows[:-1], axis=0)
    plt.imsave(path, np.clip(mosaic, 0, 1))


def loss_curves(hist: dict, keys=("d_loss", "g_loss")):
    _, plt = _pyplot()
    fig = plt.figure()
    for k in keys:
        plt.plot(hist[k], label=k)
    plt.xlabel("batch")
    plt.legend()
    return fig


def map_comparison_grid(real: np.ndarray, generated: np.ndarray,
                        dsum: np.ndarray, fractions: bool, every: int = 1,
                        fraction_cmap: str = "Greys"):
    """Evaluation map grid: row 0 the real hours, then one row per generated
    realisation; column 0 always the daily-sum condition.  `fractions`
    picks the 0..1 style in `fraction_cmap` (Greys in the base evaluation,
    generate_and_evaluate.py:243; magma_r at 64x64,
    generate_and_evaluate_largedomain.py:237), else mm on a LogNorm
    (generate_and_evaluate.py:230-303).

    One pre-colormapped mosaic under a single imshow, plus one label per
    hour column, instead of (rows+1) x (hours+1) subplot axes: the JAX
    package measured the mosaic at about a tenth of the subplots' cost."""
    matplotlib, plt = _pyplot()
    from matplotlib.colors import LogNorm

    real, generated, dsum = (np.asarray(a) for a in (real, generated, dsum))
    hours = list(range(every - 1, 24, every))
    ncols, nrows = len(hours) + 1, len(generated) + 1

    precip_cmap = matplotlib.colormaps[COND_CMAP]
    precip_norm = LogNorm(**PRECIP_NORM, clip=True)

    def precip_rgb(img):
        return precip_cmap(
            precip_norm(np.maximum(img, PRECIP_NORM["vmin"])))[..., :3]

    if fractions:
        frac_cmap = matplotlib.colormaps[fraction_cmap]

        def panel_rgb(img):
            return frac_cmap(np.clip(img, 0.0, 1.0))[..., :3]
    else:
        panel_rgb = precip_rgb

    h, w = real.shape[-2:]
    sep = max(2, w // 8)
    hsep = np.ones((h, sep, 3), dtype=np.float32)
    cond_rgb = precip_rgb(dsum)
    rows = []
    for r in range(nrows):
        src = real if r == 0 else generated[r - 1]
        panels = [cond_rgb]
        for hour in hours:
            panels.append(hsep)
            panels.append(panel_rgb(src[hour]))
        rows.append(np.concatenate(panels, axis=1))
        rows.append(np.ones((sep, rows[-1].shape[1], 3), dtype=np.float32))
    mosaic = np.concatenate(rows[:-1], axis=0)

    fig = plt.figure(figsize=(ncols, nrows))
    ax = fig.add_axes([0.0, 0.0, 1.0, 0.96])
    ax.imshow(np.clip(mosaic, 0, 1), interpolation="nearest")
    ax.axis("off")
    for c, hour in enumerate(hours):
        x = w + sep + c * (w + sep) + w / 2.0
        ax.text(x, -0.6 * sep, f"{hour + 1:02d}:00", fontsize=6,
                ha="center", va="bottom", clip_on=False)
    return fig


def close_all() -> None:
    _, plt = _pyplot()
    plt.close("all")
