"""Camera + lidar + radar late-fusion pose regressor, inference only
(counterpart of `tpufusion/models/fusion.py::FusionNet`).

  * per branch: the FCN's pre-softmax deconv6a feature map, max-pooled
    (camera (4, 1) by default, lidar optionally) -> flatten -> dense 96
    relu -> dense 48 relu (the reference's dropouts are the identity at
    inference)
  * concat(cam48, lidar48, radar [r, a, r cos a, r sin a])
  * two 2-path elu heads -> centroid (3) and yaw rz (1)

Parameter names and layouts are the reference's ('/' for '.':
`cam_branch/dense1/kernel`, `centroid_head/a/bias`,
`lidar_fcn/conv1/kernel`, dense kernels stored (in, out) as flax stores
them), so `models.io.load_arrays` loads a reference npz as it is. The
loss and the parameter filter wait for the training slice.

Where the reference's order of operations shows in the numbers it is
kept: the feature maps leave the FCNs in the compute dtype and are pooled
in it; they are flattened height, width, channel (flax is NHWC, this FCN
runs NCHW, so the pooled map is permuted back first); the dense layers
take them as float32 against float32 parameters, in full float32
(`_precision.full_f32_matmuls`) whatever the process's matmul precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpufusion_torch._precision import full_f32_matmuls
from tpufusion_torch.config import CameraConfig, ModelConfig
from tpufusion_torch.models.fcn import FCN


class Dense(nn.Module):
    """flax nnx.Linear: y = x @ kernel + bias, `kernel` is (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


class _Branch(nn.Module):
    def __init__(self, in_features: int):
        super().__init__()
        self.dense1 = Dense(in_features, 96)
        self.dense2 = Dense(96, 48)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        x = x.reshape(x.shape[0], -1)
        return F.relu(self.dense2(F.relu(self.dense1(x))))


class _TwoPathHead(nn.Module):
    def __init__(self, in_features: int, out: int):
        super().__init__()
        self.a = Dense(in_features, out)
        self.b = Dense(in_features, out)
        self.out = Dense(2 * out, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.cat([F.elu(self.a(x)), F.elu(self.b(x))], dim=-1))


def _max_pool_nhwc(x: torch.Tensor, pool: tuple[int, int]) -> torch.Tensor:
    """flax max_pool(window = strides = pool, padding="VALID") on an NHWC
    map, in x's dtype. VALID drops the remainder rows and columns
    (1368 // 8 = 171, 1801 // 8 = 225), which is `F.max_pool2d`'s default
    floor mode."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=pool, stride=pool)
    return y.permute(0, 2, 3, 1)


class FusionNet(nn.Module):
    def __init__(
        self,
        lidar_model: ModelConfig = ModelConfig(),
        camera_model: ModelConfig = ModelConfig(vertical_stride=2, use_regression=False),
        camera: CameraConfig = CameraConfig(),
        lidar_hw: tuple[int, int] = (32, 1801),
        lidar_pool: tuple[int, int] | None = None,
        cam_pool: tuple[int, int] = (4, 1),
    ):
        """lidar_pool / cam_pool: (ph, pw) max-pools over the branch
        feature maps before their dense layers. The defaults keep the
        reference's geometry (camera (4, 1), raw lidar map); the shipped
        asset uses lidar_pool (2, 8) and cam_pool (8, 8)."""
        super().__init__()
        self.lidar_fcn = FCN(lidar_model, in_channels=3)
        self.camera_fcn = FCN(camera_model, in_channels=camera.channels)
        self.lidar_pool = None if lidar_pool is None else tuple(lidar_pool)
        self.cam_pool = tuple(cam_pool)
        cam_flat = (camera.height // cam_pool[0]) * (camera.width // cam_pool[1]) * 2
        lh, lw = lidar_hw
        if lidar_pool is not None:
            lh, lw = lh // lidar_pool[0], lw // lidar_pool[1]
        self.cam_branch = _Branch(cam_flat)
        self.lidar_branch = _Branch(lh * lw * 2)
        self.centroid_head = _TwoPathHead(48 + 48 + 4, 3)
        self.rz_head = _TwoPathHead(48 + 48 + 4, 1)

    @full_f32_matmuls()
    def forward(self, cam_img, lidar_img, radar):
        """cam_img (B, Hc, Wc, 1), lidar_img (B, 32, 1801, 3), radar
        (B, 2) [range, angle] -> (centroid (B, 3), rz (B, 1)), float32."""
        cam_feat = _max_pool_nhwc(self.camera_fcn.features(cam_img), self.cam_pool)
        lidar_feat = self.lidar_fcn.features(lidar_img)
        if self.lidar_pool is not None:
            lidar_feat = _max_pool_nhwc(lidar_feat, self.lidar_pool)
        c = self.cam_branch(cam_feat)
        l = self.lidar_branch(lidar_feat)
        # radar reaches the heads in both frames, polar and cartesian
        radar = radar.to(torch.float32)
        r, a = radar[..., 0:1], radar[..., 1:2]
        radar_feats = torch.cat([r, a, r * torch.cos(a), r * torch.sin(a)], dim=-1)
        x = torch.cat([c, l, radar_feats], dim=-1)
        return self.centroid_head(x), self.rz_head(x)
