"""Batch-wise precision, recall and regression MSE (counterpart of
`tpufusion/models/metrics.py`): the foreground channel is index 1,
predictions are rounded, and an epsilon guards the divisions. The values
are 0-d tensors on the inputs' device."""

from __future__ import annotations

import torch

_EPS = 1e-7


def batch_metrics(
    y_pred: torch.Tensor, y_true: torch.Tensor, use_regression: bool = True
) -> dict[str, torch.Tensor]:
    frg_t = y_true[..., 1]
    frg_p = y_pred[..., 1]

    tp = torch.round(torch.clamp(frg_t * frg_p, 0, 1)).sum()
    pred_pos = torch.round(torch.clamp(frg_p, 0, 1)).sum()
    poss_pos = torch.round(torch.clamp(frg_t, 0, 1)).sum()

    out = {
        "precision": tp / (pred_pos + _EPS),
        "recall": tp / (poss_pos + _EPS),
    }
    if use_regression:
        diff = y_true[..., 2:] - y_pred[..., 2:]
        out["reg_mse"] = (diff * diff).mean()
    return out
