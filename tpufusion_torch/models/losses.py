"""Class-balanced weighted loss with population statistics (counterpart
of `tpufusion/models/losses.py`).

Per-pixel negative log likelihood where background pixels are scaled by
obj_to_bkg_ratio (W1) and foreground pixels by avg_obj_size /
frame_fg_area (W2), all scaled by loss_scaler; the regression head adds a
W2-weighted L2 term scaled by weight_bb. The norm is per pixel by default;
`reference_compat` takes it over the whole batch, as the reference did.

Inputs are (B, H, W, 2 + R) or (B, P, 2 + R); the loss is the mean over
all batch x pixel elements.

On a mesh each rank passes its rows (and on a spatial mesh its columns
of a global `width`). Each rank returns its share of its data row's loss:
its per-pixel terms summed over the row's global pixel count (on a
data-only mesh, their mean), so the global loss is the sum of the shares
over the mesh divided by the number of data rows. A frame's foreground
area, behind W2, is summed over the spatial axis first, and
`reference_compat`'s one batch-wide norm sums diff^2 over every rank
through a differentiable all-reduce before the root.
"""

from __future__ import annotations

import torch

from tpufusion_torch.config import LossConfig
from tpufusion_torch.parallel.mesh import all_reduce_sum


def _safe_norm(sq: torch.Tensor) -> torch.Tensor:
    """sqrt(sq) whose gradient at 0 is 0: sqrt's own is infinite there, and
    a zero-weight pixel with an exactly-zero diff would turn 0 * inf into
    NaN. The value under the root is replaced before the root is taken."""
    nonzero = sq > 0
    return torch.sqrt(torch.where(nonzero, sq, 1.0)) * nonzero


def weighted_pose_loss(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    cfg: LossConfig = LossConfig(),
    use_regression: bool = True,
    mesh=None,
    width: int | None = None,
    global_share: bool = False,
) -> torch.Tensor:
    """The loss of (B, H, W, C) or (B, P, C) predictions; on a spatial
    `mesh`, (B, H, w, C) columns of a global `width`. With `global_share`
    a rank on a mesh returns its share of the global batch's loss (its
    terms summed over the global count, every data row's frames and
    pixels; the shares sum to the loss over the whole mesh), whose
    gradient is the one-process gradient's, scale included: a small
    float's step rounds it as JAX's sharded step does."""
    spatial = mesh is not None and mesh.n_spatial > 1
    if spatial and (y_pred.ndim != 4 or width is None):
        raise ValueError("on a spatial mesh the loss takes (B, H, w, C) columns and their global width")
    max_pixels = y_true.shape[1] * width if spatial else None
    if y_pred.ndim == 4:
        b = y_pred.shape[0]
        y_pred = y_pred.reshape(b, -1, y_pred.shape[-1])
        y_true = y_true.reshape(b, -1, y_true.shape[-1])
    max_pixels = max_pixels or y_true.shape[1]

    obj_t = y_true[..., :2]
    nll = obj_t * (-torch.log(y_pred[..., :2]))  # (B, P, 2)

    bkg_t = obj_t[..., 0:1]
    frg_t = obj_t[..., 1:2]
    frg_area = frg_t.sum(dim=1, keepdim=True)
    if spatial:  # the frame's area, over its columns on every rank of the row
        frg_area = all_reduce_sum(frg_area, mesh, axis="spatial")
    frg_area = frg_area.clamp(cfg.epsilon, float(max_pixels))  # (B, 1, 1)

    w1 = cfg.obj_to_bkg_ratio * bkg_t if cfg.use_w1 else bkg_t
    w2 = frg_t * (cfg.avg_obj_size / frg_area) if cfg.use_w2 else frg_t
    loss = ((w1 + w2) * nll).sum(dim=-1) * cfg.loss_scaler  # (B, P)

    if use_regression:
        diff = y_true[..., 2:] - y_pred[..., 2:]
        if cfg.reg_channel_weights is not None:
            if len(cfg.reg_channel_weights) != diff.shape[-1]:
                raise ValueError(
                    f"reg_channel_weights has {len(cfg.reg_channel_weights)} entries for "
                    f"{diff.shape[-1]} regression channels"
                )
            # filled on the device one by one: a host copy would stall the step
            cw = torch.stack([torch.full((), w, dtype=diff.dtype, device=diff.device)
                              for w in cfg.reg_channel_weights])
            diff = diff * cw
        w2r = w2
        if cfg.reg_target_norm_clip is not None:
            # only pixels whose target is well defined are supervised; the
            # others' diffs are zeroed too, so the batch-wide norm below
            # cannot bring them back
            tnorm = torch.sqrt((y_true[..., 2:] ** 2).sum(dim=-1, keepdim=True))
            keep = tnorm <= cfg.reg_target_norm_clip
            w2r = w2 * keep
            diff = diff * keep
        if cfg.reference_compat:
            sq = (diff * diff).sum()  # one scalar for the (global) batch
            norm = _safe_norm(sq if mesh is None else all_reduce_sum(sq, mesh))
        else:
            norm = _safe_norm((diff * diff).sum(dim=-1, keepdim=True))
        loss = loss + cfg.weight_bb * (w2r * norm).sum(dim=-1)

    if global_share and mesh is not None and mesh.n_data > 1:
        return loss.sum() / (loss.shape[0] * mesh.n_data * max_pixels)
    if spatial:  # this rank's share of its row's mean
        return loss.sum() / (loss.shape[0] * max_pixels)
    return loss.mean()
