"""Inference entry points (counterpart of `tpufusion/predict.py`):

  make_e2e_step    raw point batches -> range view -> FCN -> pose decode,
                   the path every server and benchmark of the lidar
                   detector runs, for each head and obstacle count
  predict_images   offline batches of stored range-view images -> poses

`predict_dataset_dir` waits for the dataset ETL (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, DecodeConfig, PipelineConfig, RangeViewSpec
from tpufusion_torch.decode.decode import (
    decode_batch,
    decode_batch_direct,
    decode_batch_multi,
)
from tpufusion_torch.geometry.range_view import range_view_project_batch

_HEADS = ("direct", "corner")


def _decode(preds, images, spec, cfg, head: str, k: int):
    """The decode family `head` names: poses (B, 7) and found (B,) for
    k = 1, (B, k, 7) and (B, k) for k > 1."""
    if head == "direct":
        out = decode_batch_direct(preds, images, spec, cfg, k)
        if k == 1:
            return out["poses"][:, 0], out["found"][:, 0]
        return out["poses"], out["found"]
    if k > 1:
        out = decode_batch_multi(preds, images, spec, cfg, k)
        return out["poses"], out["found"]
    out = decode_batch(preds, images, spec, cfg)
    return out["pose"], out["found"]


def make_e2e_step(
    model: torch.nn.Module,
    spec: RangeViewSpec,
    decode_cfg: DecodeConfig,
    method: str = "exact",
    max_obstacles: int = 1,
    head: str = "direct",
):
    """Returns step(points (B, N, 4), valid (B, N) | None) -> (poses,
    found) on the model's device: (B, 7) and (B,) for max_obstacles = 1,
    (B, K, 7) and (B, K) top-K clusters for max_obstacles = K > 1.
    head="direct" decodes the direct-pose head, head="corner" the corner
    vote (the reference's default is "corner"; the port's is the shipped
    asset's "direct"). Inputs may be numpy arrays or tensors; they are
    moved to the model's device."""
    if head not in _HEADS:
        raise ValueError(f"unknown head {head!r}")
    if max_obstacles < 1:
        raise ValueError(f"max_obstacles must be >= 1, got {max_obstacles}")
    device = next(model.parameters()).device
    model.eval()

    def as_tensor(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=device, dtype=dtype)

    @torch.inference_mode()
    def step(points, valid=None):
        pts = as_tensor(points, torch.float32)
        ok = None if valid is None else as_tensor(valid, torch.bool)
        images = range_view_project_batch(pts, spec, ok, method)
        preds = model(images)
        return _decode(preds, images, spec, decode_cfg, head, max_obstacles)

    return step


@torch.inference_mode()
def predict_images(
    model: torch.nn.Module,
    images: np.ndarray,  # (F, H, W, 3) range-view tensors
    cfg: PipelineConfig = DEFAULT,
    batch: int = 32,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (poses (F, 7), found (F,)) as numpy. The decode follows
    cfg.model.head (the direct decode for "direct", else the corner
    vote). The last partial batch is padded with copies of its last
    frame, as the reference pads it to keep one compiled shape."""
    device = next(model.parameters()).device
    model.eval()
    spec, dcfg = cfg.range_view, cfg.decode
    head = "direct" if cfg.model.head == "direct" else "corner"
    f = len(images)
    poses = np.zeros((f, 7), np.float32)
    found = np.zeros((f,), bool)
    for lo in range(0, f, batch):
        chunk = np.array(images[lo : lo + batch], np.float32)  # a writable copy
        pad = batch - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, 0)])
        x = torch.from_numpy(chunk).to(device)
        p, fd = _decode(model(x), x, spec, dcfg, head, 1)
        poses[lo : lo + batch - pad] = p.cpu().numpy()[: batch - pad]
        found[lo : lo + batch - pad] = fd.cpu().numpy()[: batch - pad]
    return poses, found
