"""Precision/recall curve artifacts (the port's own copy of
`tpufusion/train/pr_curves.py`, numpy and the csv module): the raw
per-epoch PR plot and the recall-binned min/mean/max plot, rendered
headlessly from the trainer's `pr_curve.csv`. matplotlib is imported only
where a plot is drawn.
"""

from __future__ import annotations

import csv

import numpy as np


def load_pr_csv(path: str) -> dict[str, np.ndarray]:
    cols: dict[str, list] = {}
    with open(path) as f:
        for row in csv.DictReader(f):
            for k, v in row.items():
                cols.setdefault(k, []).append(float(v) if v else np.nan)
    return {k: np.asarray(v) for k, v in cols.items()}


def binned_pr(precision: np.ndarray, recall: np.ndarray, n_bins: int = 20):
    """Per recall-bin min/mean/max precision."""
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    mins, means, maxs, centers = [], [], [], []
    for i in range(n_bins):
        sel = (recall >= edges[i]) & (recall < edges[i + 1])
        if not sel.any():
            continue
        p = precision[sel]
        mins.append(p.min())
        means.append(p.mean())
        maxs.append(p.max())
        centers.append((edges[i] + edges[i + 1]) / 2)
    return (
        np.asarray(centers), np.asarray(mins),
        np.asarray(means), np.asarray(maxs),
    )


def plot_pr_curves(history_csv: str, out_prefix: str) -> list[str]:
    """Writes <prefix>_pr.png and <prefix>_pr_binned.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = load_pr_csv(history_csv)
    prec, rec = cols["precision"], cols["recall"]
    paths = []

    fig, ax = plt.subplots()
    ax.plot(rec, prec, ".-", label="train")
    if "val_recall" in cols and np.isfinite(cols["val_recall"]).any():
        ax.plot(cols["val_recall"], cols["val_precision"], ".-", label="val")
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.legend()
    p = f"{out_prefix}_pr.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)

    centers, mins, means, maxs = binned_pr(prec, rec)
    fig, ax = plt.subplots()
    if len(centers):
        ax.plot(centers, means, "-", label="mean")
        ax.fill_between(centers, mins, maxs, alpha=0.3, label="min/max")
    ax.set_xlabel("recall bin")
    ax.set_ylabel("precision")
    ax.legend()
    p = f"{out_prefix}_pr_binned.png"
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)
    return paths
