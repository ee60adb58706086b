"""Per-epoch training figures (agg backend, the reference's file names).

The sample grid of the reference (gan_train_cwgangp_pixelnorm.py:411-425,
494-508) as one colormapped mosaic written with a single ``imsave``, and the
loss curves (:511-516), as the JAX package draws them (utils/plotting.py
there).  ``matplotlib`` is imported inside the functions: a run that plots
nothing does not need it.
"""

from __future__ import annotations

import numpy as np

COND_CMAP = "gist_earth_r"
COND_NORM = dict(vmin=0.01, vmax=1)


def _pyplot():
    import matplotlib

    matplotlib.use("agg")
    import matplotlib.pyplot as plt

    return matplotlib, plt


def sample_grid_mosaic(fractions: np.ndarray, cond: np.ndarray, path: str,
                       sep: int = 2) -> None:
    """One row per sample: the condition map, then the hourly fractions
    (all of them; the reference's subplot loop skips hour 0).

    fractions: (n, nh, nd, nd[, 1]); cond: (n, nd, nd[, c]), channel 0
    drawn.  A mosaic with one ``imsave`` instead of n x 25 subplots: the JAX
    package measured the subplot figure at about 30x the cost."""
    matplotlib, plt = _pyplot()
    from matplotlib.colors import LogNorm

    fractions = np.asarray(fractions)
    cond = np.asarray(cond)
    if fractions.ndim == 5:
        fractions = fractions[..., 0]
    if cond.ndim == 4:
        cond = cond[..., 0]
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


def close_all() -> None:
    _, plt = _pyplot()
    plt.close("all")
