"""The fused inference step (counterpart of `tpufusion/predict.py::
make_e2e_step`): raw point batches -> range view -> FCN -> direct-pose
decode, the path every server and benchmark of the lidar detector runs.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion.config import DecodeConfig, RangeViewSpec
from tpufusion_torch.decode.decode import decode_batch_direct
from tpufusion_torch.geometry.range_view import range_view_project_batch


def make_e2e_step(
    model: torch.nn.Module,
    spec: RangeViewSpec,
    decode_cfg: DecodeConfig,
    method: str = "exact",
    max_obstacles: int = 1,
    head: str = "direct",
):
    """Returns step(points (B, N, 4), valid (B, N) | None) -> (poses (B, 7),
    found (B,)) on the model's device. Inputs may be numpy arrays or
    tensors; they are moved to the model's device."""
    if head != "direct":
        raise NotImplementedError(
            f"head={head!r} is not ported yet (ROADMAP Queue 1: the corner decode)"
        )
    if max_obstacles != 1:
        raise NotImplementedError(
            "max_obstacles > 1 is not ported yet (ROADMAP Queue 1: "
            "multi-obstacle decode)"
        )
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
        out = decode_batch_direct(preds, images, spec, decode_cfg, max_obstacles)
        return out["poses"][:, 0], out["found"][:, 0]

    return step
