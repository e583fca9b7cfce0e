"""Online inference facade (counterpart of `tpufusion/serve/pipeline.py::
LidarPipeline`): one fused step (projection + FCN + decode) behind a
`predict_position(points)` call, plus the reference's `fake_predict`
(the cloud's mean, for smoke-testing transports without weights).

Unlike the reference facade, the step is built with the model's own head
(`head=cfg.model.head`), so a direct-head asset decodes through the
direct decode.
"""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, PipelineConfig
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import asset_configs, load_state_npz
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.train.checkpoint import CheckpointManager


class LidarPipeline:
    def __init__(
        self,
        cfg: PipelineConfig = DEFAULT,
        model: FCN | None = None,
        checkpoint_dir: str | None = None,
        max_points: int | None = None,
        device: torch.device | str = "cuda",
    ):
        """The reference's parameters, in its order, then `device`. A
        missing model is a fresh FCN drawn from seed 0 (the reference's
        initialiser's distribution, not its values); `checkpoint_dir`
        restores the newest `ckpt_<step>.pt` there into it. The model is
        moved to `device`: the card unless the caller asks for "cpu"
        (without a card, "cuda" raises)."""
        self.cfg = cfg
        self.max_points = max_points or cfg.max_points
        model = model if model is not None else FCN(cfg.model, in_channels=3, seed=0)
        if checkpoint_dir is not None:
            CheckpointManager(checkpoint_dir).restore(model, device=device)
        self.model = model.to(device).eval()
        self._step = make_e2e_step(
            self.model, cfg.range_view, cfg.decode, cfg.projection_method,
            head=cfg.model.head, device=device,
        )

    @classmethod
    def from_asset(
        cls,
        path: str,
        device: torch.device | str = "cuda",
        max_points: int | None = None,
    ) -> "LidarPipeline":
        """A detector asset: weights `path` (.npz) plus `path + ".json"`,
        whose "model" and "decode" entries override the config defaults.
        An unreadable or mismatched asset raises."""
        mcfg, dcfg = asset_configs(path)
        cfg = DEFAULT.replace(model=mcfg, decode=dcfg)
        model = FCN(mcfg, in_channels=3)
        load_state_npz(path, model)
        return cls(cfg=cfg, model=model, max_points=max_points, device=device)

    def _pad(self, points: np.ndarray):
        n = self.max_points
        pts = np.zeros((n, 4), np.float32)
        valid = np.zeros((n,), bool)
        m = min(len(points), n)
        pts[:m, : points.shape[1]] = points[:m, :4]
        valid[:m] = True
        return pts, valid

    def predict_position(self, points: np.ndarray) -> tuple[np.ndarray, bool]:
        """points (N, >=3[+intensity]) -> (pose (7,), found)."""
        pts, valid = self._pad(np.asarray(points, np.float32))
        pose, found = self._step(pts[None], valid[None])
        return pose[0].cpu().numpy(), bool(found[0])

    @staticmethod
    def fake_predict(points: np.ndarray) -> np.ndarray:
        """Mean of the cloud — the reference node's fake_model."""
        return np.asarray(points, np.float64)[:, :3].mean(axis=0)
