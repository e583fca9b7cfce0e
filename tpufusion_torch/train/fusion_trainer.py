"""Fusion (camera + lidar + radar) training (counterpart of
`tpufusion/train/fusion_trainer.py`): an MSE train step with optional
sub-network locking and Adam under the plateau rule. The samples are
joined by `data.fusion.build_fusion_batches`; the inference loop is
`serve.fusion.predict_fusion`.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpufusion_torch.models.fusion import FusionNet, fusion_loss, trainable_parameters
from tpufusion_torch.train.optim import Adam, ReduceOnPlateau

log = logging.getLogger("tpufusion_torch.fusion")

_KEYS = ("cam", "lidar", "radar", "centroid", "rz")
COMPLEX_GRAD_ERROR = ("grad requires real-valued outputs (output dtype that is a sub-dtype of "
                      "np.floating), but got {}: the fusion loss of a net with a complex FCN, "
                      "which JAX's fusion step refuses")


def make_fusion_train_step():
    """step(net, opt, cam, lidar, radar, centroid, rz, rows, generator) ->
    the loss, a 0-d tensor on the device. The dataset lies on the device
    and the batch is gathered there by `rows`, so a step copies nothing
    from the host but the row indices. `generator` feeds the dropouts."""

    def step(net, opt, cam, lidar, radar, centroid, rz, rows, generator=None):
        opt.zero_grad(set_to_none=True)
        outputs = net(cam[rows], lidar[rows], radar[rows], train=True, generator=generator)
        loss = fusion_loss(outputs, (centroid[rows], rz[rows]))
        if loss.is_complex():  # a complex FCN's net: JAX's grad refuses it at the first step
            raise TypeError(COMPLEX_GRAD_ERROR.format(loss.dtype))
        loss.backward()
        loss = loss.detach()
        opt.step(value=loss)  # the plateau rule reads the loss
        return loss

    return step


def make_fusion_tx(params, lr: float, steps_per_epoch: int,
                   device: torch.device | str = "cuda") -> Adam:
    """Adam under the plateau rule as the reference sets it: the rule sees
    a step's batch loss, so it averages a whole epoch of them
    (accumulation_size) before it compares, waits patience = 3 such
    windows, halves, and cools down for 1. Patience and cooldown count
    windows, not steps."""
    plateau = ReduceOnPlateau(
        patience=3, factor=0.5, accumulation_size=steps_per_epoch, cooldown=1, device=device)
    return Adam(params, lr, plateau=plateau)


def train_fusion(
    net: FusionNet,
    data: dict[str, np.ndarray],
    epochs: int = 10,
    batch_size: int = 8,
    lr: float = 1e-3,
    lock_lidar: bool = False,
    lock_camera: bool = False,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> list[float]:
    """Trains `net` in place on `device` (the card unless the caller asks
    for "cpu") and returns each epoch's mean loss. The whole dataset is
    staged on the device once; the last partial batch of an epoch is
    dropped, as in the reference; one loss is read back a step."""
    device = torch.device(device)
    net.to(device)
    n = len(data["cam"])
    steps_per_epoch = max(1, max(n - batch_size, 0) // batch_size + 1)
    opt = make_fusion_tx(
        trainable_parameters(net, lock_lidar, lock_camera), lr, steps_per_epoch, device)
    step = make_fusion_train_step()
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    dev = {k: torch.from_numpy(np.ascontiguousarray(data[k])).to(device) for k in _KEYS}
    losses = []
    for epoch in range(epochs):
        order = rng.permutation(n)
        epoch_losses = []
        for lo in range(0, n - batch_size + 1, batch_size):
            rows = torch.from_numpy(order[lo : lo + batch_size]).to(device)
            loss = step(net, opt, *(dev[k] for k in _KEYS), rows, generator)
            epoch_losses.append(float(loss))
        mean_loss = float(np.mean(epoch_losses)) if epoch_losses else 0.0
        losses.append(mean_loss)
        log.info("fusion epoch %d loss %.5f", epoch, mean_loss)
    return losses
