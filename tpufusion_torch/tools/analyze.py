"""Ground-truth distribution analyzer (a copy of `tpufusion/tools/analyze.py`).

Rebuilds `modules/lidar/train/analyze.py:12-55`: a polar 2D histogram of
obstacle ground-truth positions (azimuth x range), useful for spotting
dataset bias before training. Returns arrays; optionally renders a PNG
(matplotlib, imported where the plot is drawn).
"""

from __future__ import annotations

import numpy as np


def polar_histogram(
    centers: np.ndarray,  # (F, >=2) tx, ty
    n_azimuth: int = 36,
    n_range: int = 20,
    max_range: float = 60.0,
):
    c = np.asarray(centers, float)
    az = np.arctan2(c[:, 1], c[:, 0])
    rng = np.hypot(c[:, 0], c[:, 1])
    hist, az_edges, r_edges = np.histogram2d(
        az,
        rng,
        bins=(
            np.linspace(-np.pi, np.pi, n_azimuth + 1),
            np.linspace(0, max_range, n_range + 1),
        ),
    )
    return hist, az_edges, r_edges


def save_polar_plot(centers: np.ndarray, path: str, **kw) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    hist, az_edges, r_edges = polar_histogram(centers, **kw)
    fig = plt.figure()
    ax = fig.add_subplot(projection="polar")
    pc = ax.pcolormesh(az_edges, r_edges, hist.T, shading="auto")
    fig.colorbar(pc)
    fig.savefig(path, dpi=100)
    plt.close(fig)
