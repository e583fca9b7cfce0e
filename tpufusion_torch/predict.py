"""Inference entry points (counterpart of `tpufusion/predict.py`):

  make_e2e_step    raw point batches -> range view -> FCN -> pose decode,
                   the path every server and benchmark of the lidar
                   detector runs, for each head and obstacle count
  predict_images   offline batches of stored range-view images -> poses
  predict_dataset_dir  an extracted dataset dir -> the prediction and
                   metadata CSVs
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, DecodeConfig, PipelineConfig, RangeViewSpec
from tpufusion_torch.decode.decode import (
    decode_batch,
    decode_batch_direct,
    decode_batch_multi,
)
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.parallel.mesh import all_gather_columns, constrain_spatial

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
    device: torch.device | str = "cuda",
    mesh=None,
):
    """Returns step(points (B, N, 4), valid (B, N) | None) -> (poses,
    found) on `device`: (B, 7) and (B,) for max_obstacles = 1,
    (B, K, 7) and (B, K) top-K clusters for max_obstacles = K > 1.
    head="direct" decodes the direct-pose head, head="corner" the corner
    vote (the reference's default is "corner"; the port's is the shipped
    asset's "direct"). The model is moved to `device` (the card unless
    the caller asks for "cpu"; without a card that raises) and the
    inputs, numpy arrays or tensors, follow it.

    With a `mesh` (`parallel/mesh.py`; `device` is then the mesh's) each
    rank passes its data row's frames and projects them at full width;
    on a spatial mesh the image is cut to this rank's columns, the FCN
    runs width-sharded, its maps are gathered back to the whole width and
    every rank of the row decodes the same poses."""
    if head not in _HEADS:
        raise ValueError(f"unknown head {head!r}")
    if max_obstacles < 1:
        raise ValueError(f"max_obstacles must be >= 1, got {max_obstacles}")
    device = mesh.device if mesh is not None else torch.device(device)
    model.to(device).eval()

    def as_tensor(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=device, dtype=dtype)

    @torch.inference_mode()
    def step(points, valid=None):
        pts = as_tensor(points, torch.float32)
        ok = None if valid is None else as_tensor(valid, torch.bool)
        images = range_view_project_batch(pts, spec, ok, method)
        if mesh is None or mesh.n_spatial == 1:
            preds = model(images)
        else:
            width = images.shape[2]
            preds = model(constrain_spatial(images, mesh), mesh=mesh, width=width)
            preds = all_gather_columns(preds, mesh, width)
        return _decode(preds, images, spec, decode_cfg, head, max_obstacles)

    return step


@torch.inference_mode()
def predict_images(
    model: torch.nn.Module,
    images: np.ndarray,  # (F, H, W, 3) range-view tensors
    cfg: PipelineConfig = DEFAULT,
    batch: int = 32,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (poses (F, 7), found (F,)) as numpy. The decode follows
    cfg.model.head (the direct decode for "direct", else the corner
    vote). The last partial batch is padded with copies of its last
    frame, as the reference pads it to keep one compiled shape. The
    model is moved to `device` (without a card, "cuda" raises)."""
    device = torch.device(device)
    model.to(device).eval()
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


def predict_dataset_dir(
    model: torch.nn.Module,
    dataset_dir: str,
    output_dir: str,
    cfg: PipelineConfig = DEFAULT,
    batch: int = 32,
    device: torch.device | str = "cuda",
) -> dict:
    """Extracted-dataset dir (either layout of `data.etl.load_extracted`)
    -> `objects_obs1_lidar_predictions.csv` and `objects_obs1_metadata.csv`
    in `output_dir`, the model run on `device` (the card unless the caller
    asks for "cpu")."""
    from tpufusion_torch.data.etl import load_extracted
    from tpufusion_torch.eval.submission import write_metadata_csv, write_predictions_csv

    data = load_extracted(dataset_dir)
    poses, found = predict_images(model, data["images"], cfg, batch, device)
    os.makedirs(output_dir, exist_ok=True)
    pred_csv = os.path.join(output_dir, "objects_obs1_lidar_predictions.csv")
    meta_csv = os.path.join(output_dir, "objects_obs1_metadata.csv")
    write_predictions_csv(
        [(p[0], p[1], p[2], p[3], p[4], p[5], p[6]) for p in poses],
        list(map(int, data["timestamps"])),
        pred_csv,
    )
    write_metadata_csv(poses, meta_csv)
    return {
        "frames": len(poses),
        "detections": int(found.sum()),
        "predictions_csv": pred_csv,
        "metadata_csv": meta_csv,
    }
