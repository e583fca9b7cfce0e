"""Train and eval steps (counterpart of `tpufusion/train/train_step.py`).

Everything the reference did on the host for each batch happens on the
device here too: the point projection (the z-buffer kernel on the card),
the label encoding, the azimuth-roll augmentation, forward, loss,
backward, the optimizer update and the metrics. Nothing in a step reads a
value back: the loss and the metrics are returned as 0-d tensors on the
device.

Batches are dicts of tensors (or numpy arrays) with either precomputed
range-view `images` (B, H, W, 3) or raw `points` (B, N, 4) (+ `valid`
(B, N)) to project, plus the ground truth `center` (B, 3), `size` (B, 3),
`yaw` (B,), or precomputed `labels`. Each step is made for a `device`
(the card unless the caller asks for "cpu"): the model is moved there and
the batch follows, which costs nothing when both already lie there, as a
`BatchPipeline`'s batches and a `Trainer`'s model do.

With a `mesh` (`parallel/mesh.py`) each rank passes its data row's rows
of the global batch (`BatchPipeline(sharding=batch_sharding(mesh))` or
`shard_batch`) and a model whose weights equal every other rank's
(`replicate`): the step takes BatchNorm's statistics over the global
batch, draws the roll for the global batch, and returns the global loss
and metrics, which the optimizer's plateau rule reads too. On a spatial
mesh the labels and the roll are made at full width first (the roll
moves the image along the width), then images and labels are cut to this
rank's columns (`constrain_spatial`, as the reference pins them to the
data x spatial layout) and the FCN runs width-sharded. Each rank's
gradient is its share of its data row's; one flat all-reduce sums them
over the mesh and divides by the number of data rows before the
optimizer. A small-float FCN (`model.fmt`) takes its share of the global
batch's loss instead and combines its gradients in the format, as XLA's
partitioned program does (`parallel.mesh.reduce_gradients`). The
collectives are enqueued on the stream; nothing waits for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import LossConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.data.augment import augment_batch
from tpufusion_torch.geometry.encoding import encode_direct_label_batch, encode_label_batch
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models.losses import weighted_pose_loss
from tpufusion_torch.models.metrics import batch_metrics
from tpufusion_torch.parallel.mesh import (
    Mesh,
    all_reduce_mean,
    all_reduce_sum,
    average_gradients,
    constrain_spatial,
    reduce_gradients,
)


def _on_device(model: torch.nn.Module, batch: dict, device: torch.device):
    """(model, batch) on `device`; numpy arrays become tensors."""
    def put(v):
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        return v.to(device)

    return model.to(device), {k: put(v) for k, v in batch.items()}


def _batch_images(batch, spec: RangeViewSpec) -> torch.Tensor:
    if "images" in batch:
        return batch["images"]
    # per-point validity: beam scans mark no-return rays, dropped like padding
    return range_view_project_batch(batch["points"], spec, batch.get("valid"))


@torch.no_grad()
def encode_batch(batch, spec: RangeViewSpec, head: str, yaw_frame: str):
    """(images, labels) of a batch, with no gradient: the projection of a
    `points` batch and the label encode of the head's codec."""
    images = _batch_images(batch, spec)
    if "labels" in batch:
        # precomputed labels (camera-source training)
        return images, batch["labels"]
    gt = (batch["center"], batch["size"], batch["yaw"])
    if head == "direct":
        return images, encode_direct_label_batch(*gt, images, spec, yaw_frame=yaw_frame)
    return images, encode_label_batch(*gt, images, spec)


def make_train_step(
    spec: RangeViewSpec,
    loss_cfg: LossConfig,
    train_cfg: TrainConfig,
    use_regression: bool = True,
    mesh=None,
    head: str = "corner",
    yaw_frame: str = "local",
    device: torch.device | str = "cuda",
):
    """Returns train_step(model, optimizer, batch, generator) -> (loss,
    metrics), 0-d tensors on `device` (the card unless the caller asks for
    "cpu"; without a card the step raises).

    head="direct" encodes the direct-pose targets with the `yaw_frame`
    codec ("local", "global" or "both"; the decode must use the matching
    DecodeConfig.direct_yaw_frame) instead of the 24-dim corner field, and
    skips the azimuth-roll augmentation (its sin/cos channels are not
    roll-invariant as stored). `generator` feeds the augmentation's draws;
    a batch may carry `shifts` (B,) to roll by instead. `optimizer` is
    `train.optim.Adam`: with every_k > 1 the parameters move on every
    k-th call only; with a plateau rule it reads the step's loss.

    `mesh` (a `parallel.mesh.Mesh`) makes it the data-parallel step of the
    module docstring, on the mesh's device (`device` is then unused)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    device = mesh.device if mesh is not None else torch.device(device)

    def train_step(model, optimizer, batch, generator=None):
        model, batch = _on_device(model, batch, device)
        images, labels = encode_batch(batch, spec, head, yaw_frame)
        if train_cfg.augment and "labels" not in batch and head != "direct":
            with torch.no_grad():
                images, labels = augment_batch(
                    generator, images, labels, batch["center"], batch["size"],
                    batch["yaw"], spec, shifts=batch.get("shifts"), mesh=mesh,
                )
        width = images.shape[2]
        if mesh is not None:
            images, labels = constrain_spatial(images, mesh), constrain_spatial(labels, mesh)
        optimizer.zero_grad(set_to_none=True)
        preds = model(images, train=True, mesh=mesh, width=width)
        fmt = getattr(model, "fmt", None) if mesh is not None else None
        loss = weighted_pose_loss(preds, labels, loss_cfg, use_regression, mesh=mesh, width=width,
                                  global_share=fmt is not None)
        loss.backward()
        loss = loss.detach()
        if fmt is not None:  # a small float: XLA's partitioned combine, in the format
            reduce_gradients(model.gradient_plan(), mesh, fmt)
            loss = all_reduce_sum(loss, mesh)
        elif mesh is not None:
            average_gradients(model.parameters(), mesh)
            loss = all_reduce_mean(loss, mesh)
        optimizer.step(value=loss)
        with torch.no_grad():
            metrics = batch_metrics(preds.detach(), labels, use_regression, mesh, width)
        metrics["loss"] = loss
        return loss, metrics

    return train_step


def make_eval_step(
    spec: RangeViewSpec,
    loss_cfg: LossConfig,
    use_regression: bool = True,
    head: str = "corner",
    yaw_frame: str = "local",
    device: torch.device | str = "cuda",
):
    """Eval twin of make_train_step: eval_step(model, batch) -> (loss,
    metrics) with the running statistics and no gradient."""
    device = torch.device(device)

    @torch.no_grad()
    def eval_step(model, batch):
        model, batch = _on_device(model, batch, device)
        images, labels = encode_batch(batch, spec, head, yaw_frame)
        preds = model(images, train=False)
        loss = weighted_pose_loss(preds, labels, loss_cfg, use_regression)
        metrics = batch_metrics(preds, labels, use_regression)
        metrics["loss"] = loss
        return loss, metrics

    return eval_step


def make_forward(spec: RangeViewSpec, device: torch.device | str = "cuda"):
    """Inference forward: forward(model, points) -> (images, predictions),
    the projection + FCN part of the end-to-end path."""
    device = torch.device(device)

    @torch.no_grad()
    def forward(model, points):
        model, moved = _on_device(model, {"points": points}, device)
        points = moved["points"]
        images = range_view_project_batch(points, spec)
        return images, model(images, train=False)

    return forward
