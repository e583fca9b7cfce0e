"""Camera + lidar + radar late-fusion pose regressor (counterpart of
`tpufusion/models/fusion.py`: `FusionNet`, `fusion_loss`, and
`trainable_parameters` for its `trainable_filter`).

  * per branch: the FCN's pre-softmax deconv6a feature map, max-pooled
    (camera (4, 1) by default, lidar optionally) -> flatten -> dropout 0.2
    -> dense 96 relu -> dropout 0.2 -> dense 48 relu (the dropouts are
    the identity unless train=True)
  * concat(cam48, lidar48, radar [r, a, r cos a, r sin a])
  * two 2-path elu heads -> centroid (3) and yaw rz (1)

Parameter names and layouts are the reference's ('/' for '.':
`cam_branch/dense1/kernel`, `centroid_head/a/bias`,
`lidar_fcn/conv1/kernel`, dense kernels stored (in, out) as flax stores
them), so `models.io.load_arrays` loads a reference npz as it is.

Training: dropout masks are drawn from the `torch.Generator` handed to
`forward` (on the net's device), never from the global state; a keep mask
of share 0.8 scaled by 1/0.8, as flax's Dropout. Its bits differ from
`jax.random`'s. Locking a sub-network (`trainable_parameters`) only keeps
its parameters from the optimizer: as in the reference the locked FCN
still runs with train=True, so its BatchNorm's running statistics move.

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
from tpufusion_torch.models.fcn import FCN, uniform_init_


class Dense(nn.Module):
    """flax nnx.Linear: y = x @ kernel + bias, `kernel` is (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() @ self.kernel + self.bias


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """flax's Dropout in training: each element kept with probability
    1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    `generator` on x's device. rate 0 returns x and draws nothing."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator on the net's device")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _Branch(nn.Module):
    def __init__(self, in_features: int, rate: float = 0.2):
        super().__init__()
        self.rate = rate  # of both dropouts; a test may set it to 0.0
        self.dense1 = Dense(in_features, 96)
        self.dense2 = Dense(96, 48)

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)  # (B, H, W, C) flattened
        if train:
            x = dropout(x, self.rate, generator)
        x = F.relu(self.dense1(x))
        if train:
            x = dropout(x, self.rate, generator)
        return F.relu(self.dense2(x))


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
    floor mode. Where a window holds its maximum more than once (common in
    a bf16 map) the gradient goes to the first one in row-major order, on
    the CPU and on the card, as XLA sends it."""
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
        for fcn in (self.lidar_fcn, self.camera_fcn):
            if fcn.fmt is not None:  # JAX raises at its dense layers' promotion
                raise TypeError(f"FusionNet: the {fcn.cfg.dtype} features meet float32 dense "
                                "layers, a promotion JAX refuses for its small floats")
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
    def forward(self, cam_img, lidar_img, radar, train: bool = False,
                generator: torch.Generator | None = None):
        """cam_img (B, Hc, Wc, 1), lidar_img (B, 32, 1801, 3), radar
        (B, 2) [range, angle] -> (centroid (B, 3), rz (B, 1)), float32
        (complex64 with a zero imaginary part where an FCN is complex, as
        JAX's).
        train=True: both FCNs' BatchNorms use the batch's statistics and
        the branches' dropouts draw from `generator`."""
        cam_feat = _max_pool_nhwc(_real(self.camera_fcn.features(cam_img, train)), self.cam_pool)
        lidar_feat = _real(self.lidar_fcn.features(lidar_img, train))
        if self.lidar_pool is not None:
            lidar_feat = _max_pool_nhwc(lidar_feat, self.lidar_pool)
        c = self.cam_branch(cam_feat, train, generator)
        l = self.lidar_branch(lidar_feat, train, generator)
        # radar reaches the heads in both frames, polar and cartesian
        radar = radar.to(torch.float32)
        r, a = radar[..., 0:1], radar[..., 1:2]
        radar_feats = torch.cat([r, a, r * torch.cos(a), r * torch.sin(a)], dim=-1)
        x = torch.cat([c, l, radar_feats], dim=-1)
        centroid, rz = self.centroid_head(x), self.rz_head(x)
        if self.lidar_fcn.complex or self.camera_fcn.complex:
            return centroid.to(torch.complex64), rz.to(torch.complex64)
        return centroid, rz


def _real(feat: torch.Tensor) -> torch.Tensor:
    """A complex FCN's features (complex64, a zero imaginary part) as
    their real part: JAX's complex net keeps the imaginary part exactly
    zero through the max-pools (complex values ordered by real part,
    then imaginary), the dense layers, relu and elu, so the float32 net
    computes its real part."""
    return feat.real if feat.is_complex() else feat


def fusion_loss(outputs, targets) -> torch.Tensor:
    """MSE over both heads."""
    centroid, rz = outputs
    t_centroid, t_rz = targets
    return ((centroid - t_centroid) ** 2).mean() + ((rz - t_rz) ** 2).mean()


def trainable_parameters(
    net: FusionNet, lock_lidar: bool = False, lock_camera: bool = False
) -> list[nn.Parameter]:
    """The parameters the optimizer receives: all of them but those of a
    locked FCN (the reference freezes layers by name)."""
    locked = tuple(
        prefix for prefix, lock in (("lidar_fcn.", lock_lidar), ("camera_fcn.", lock_camera))
        if lock
    )
    return [p for name, p in net.named_parameters() if not (locked and name.startswith(locked))]


def init_fusion_(net: FusionNet, seed: int) -> None:
    """Draws the net's weights as the reference's constructor does, from a
    CPU generator made of `seed`: every conv kernel and every dense kernel
    but the heads' `out` from U(-0.05, 0.05), the heads' `out` kernels from
    flax's default lecun-normal (a normal of variance 1 / fan_in truncated
    at two standard deviations), biases zero. The distribution is the
    reference's; the values are not its values for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    uniform_init_(net, gen)
    with torch.no_grad():
        for head in (net.centroid_head, net.rz_head):
            kernel = head.out.kernel
            std = (1.0 / kernel.shape[0]) ** 0.5 / 0.87962566103423978
            fresh = torch.empty(kernel.shape)
            nn.init.trunc_normal_(fresh, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            kernel.copy_(fresh)
