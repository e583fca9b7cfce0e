"""Batch-wise precision, recall and regression MSE (counterpart of
`tpufusion/models/metrics.py`): the foreground channel is index 1,
predictions are rounded, and an epsilon guards the divisions. The values
are 0-d tensors on the inputs' device. On a mesh the counts (true
positives, predicted and actual positives) are summed over the ranks
before the ratios, and each rank's share of the MSE (on a spatial mesh,
its squared errors over its data row's global count) summed and divided
by the number of data rows, so every rank reports the global batch's
metrics."""

from __future__ import annotations

import torch
import torch.distributed as dist

_EPS = 1e-7


def batch_metrics(
    y_pred: torch.Tensor, y_true: torch.Tensor, use_regression: bool = True, mesh=None,
    width: int | None = None,
) -> dict[str, torch.Tensor]:
    """On a spatial `mesh` the inputs are (B, H, w, C) columns of a global
    `width`."""
    frg_t = y_true[..., 1]
    frg_p = y_pred[..., 1]

    tp = torch.round(torch.clamp(frg_t * frg_p, 0, 1)).sum()
    pred_pos = torch.round(torch.clamp(frg_p, 0, 1)).sum()
    poss_pos = torch.round(torch.clamp(frg_t, 0, 1)).sum()
    terms = [tp, pred_pos, poss_pos]
    if use_regression:
        diff = y_true[..., 2:] - y_pred[..., 2:]
        if mesh is not None and mesh.n_spatial > 1:
            terms.append((diff * diff).sum() / (diff.numel() // diff.shape[2] * width))
        else:
            terms.append((diff * diff).mean())
    if mesh is not None:  # one all-reduce of the sums, not of the ratios
        summed = torch.stack(terms)
        dist.all_reduce(summed, group=mesh.group)
        terms = list(summed.unbind(0))
        if use_regression:
            terms[3] = terms[3] / mesh.n_data
    tp, pred_pos, poss_pos = terms[:3]
    out = {
        "precision": tp / (pred_pos + _EPS),
        "recall": tp / (poss_pos + _EPS),
    }
    if use_regression:
        out["reg_mse"] = terms[3]
    return out
