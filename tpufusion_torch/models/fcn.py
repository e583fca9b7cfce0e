"""Fully convolutional segmentation + regression network, inference only
(counterpart of `tpufusion/models/fcn.py::FCN`).

  input (B, H, W, C) NHWC
    -> feature-wise BatchNorm (running stats, eps 1e-3)
    -> zero-pad width (0, 3)
    -> conv1/2/3 5x5, strides (vs, 4)/(vs, 2)/(vs, 2), relu
    -> deconv4 (vs, 2) relu, concat conv2
    -> cls: deconv5a (vs, 2) relu, crop left crop5, concat conv1,
            deconv6a (vs, 4), crop to W, softmax, clip(1e-7, 1)
    -> reg: deconv5b/6b mirror (linear, or relu for a relu corner head)
  output (B, H, W, 2 + reg) NHWC, float32
  features(x): the pre-softmax deconv6a map, NHWC, compute dtype

vs = 1 for the lidar range view (32 x 1801 x 3) and the BEV (180 x 1197
x 3), vs = 2 without the regression branch for the camera (512 x 1368 x 1).

dtype "bfloat16" computes as flax does with dtype=bf16 and float32
params: each conv casts its input, kernel and bias to bf16 and adds the
bias after the convolution, activations stay bf16 between layers, the
BatchNorm runs on the float32 input, the softmax on d6a cast to float32,
and the regression output is cast to float32. Parameters stay float32,
so the same npz loads for either dtype.

Weights keep flax's layouts (kernels HWIO) in the state dict so the npz
keys and arrays load as they are; the forward maps them to torch's:
flax "SAME" pads more at the end for strided convs, so padding is an
explicit `F.pad`; flax `ConvTranspose(transpose_kernel=False)` is a conv
over the stride-dilated input with the unflipped kernel and padding
(k + s - 2) split as jax's `_conv_transpose_padding`.
Convolutions go to torch's own conv ops (cuDNN on the card), as the
reference leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpufusion_torch.config import ModelConfig

_KERAS_EPSILON = 1e-7
_K = 5
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DIRECT_CHANNELS = 8  # geometry/encoding.py: dc(3), lwh(3), sin, cos
DIRECT_CHANNELS_DUAL = 10


def _same_pad(n: int, s: int, k: int = _K) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _transpose_pad(s: int, k: int = _K) -> tuple[int, int]:
    """jax's _conv_transpose_padding(k, s, "SAME")."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


def _bias(bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """flax's `y += bias` after the convolution, in the compute dtype."""
    return bias.to(x.dtype).view(-1, 1, 1)


def uniform_init_(model: nn.Module, seed: int) -> None:
    """Draws every `kernel` of `model` from U(-0.05, 0.05) (keras's
    random_uniform, the reference FCN's initializer) with a generator
    made from `seed`; biases and the BatchNorm stay as built (zeros, the
    identity). For benchmarks and smoke runs that need weights but no
    trained asset; the values are not the reference's for the same seed."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, param in model.named_parameters():
            if name.endswith("kernel"):
                param.copy_(torch.rand(param.shape, generator=gen) * 0.1 - 0.05)


class Conv(nn.Module):
    """flax nnx.Conv(k=5, padding="SAME"); `kernel` is HWIO."""

    def __init__(self, cin: int, cout: int, strides: tuple[int, int]):
        super().__init__()
        self.strides = strides
        self.kernel = nn.Parameter(torch.zeros(_K, _K, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW, x's dtype
        (sh, sw), (h, w) = self.strides, x.shape[2:]
        ph, pw = _same_pad(h, sh), _same_pad(w, sw)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        wt = self.kernel.to(x.dtype).permute(3, 2, 0, 1)  # OIHW
        return F.conv2d(x, wt, stride=self.strides) + _bias(self.bias, x)


class ConvTranspose(nn.Module):
    """flax nnx.ConvTranspose(k=5, padding="SAME"); `kernel` is HWIO.

    Written as flax computes it: insert stride-1 zeros between inputs,
    pad (pad_a, pad_b), correlate with the unflipped kernel. On the H100
    this is faster than `F.conv_transpose2d` (cuDNN's float32 dgrad path):
    17.8 vs 27.2 ms for the asset's FCN at batch 64, 1.5 vs 17.0 ms at
    batch 1 (H100 80GB HBM3, 700 W)."""

    def __init__(self, cin: int, cout: int, strides: tuple[int, int]):
        super().__init__()
        self.strides = strides
        self.kernel = nn.Parameter(torch.zeros(_K, _K, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NCHW
        (sh, sw), (b, c, h, w) = self.strides, x.shape
        z = x.new_zeros(b, c, (h - 1) * sh + 1, (w - 1) * sw + 1)
        z[:, :, ::sh, ::sw] = x
        ph, pw = _transpose_pad(sh), _transpose_pad(sw)
        z = F.pad(z, (pw[0], pw[1], ph[0], ph[1]))
        wt = self.kernel.to(x.dtype).permute(3, 2, 0, 1)
        return F.conv2d(z, wt) + _bias(self.bias, x)


class BatchNorm(nn.Module):
    """Feature-wise inference BatchNorm over the channel axis (NCHW)."""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(self.var + self.epsilon) * self.scale
        c = (-1, 1, 1)
        return (x - self.mean.view(c)) * mul.view(c) + self.bias.view(c)


class FCN(nn.Module):
    def __init__(self, cfg: ModelConfig, in_channels: int = 3):
        super().__init__()
        if cfg.sample_wise_bn:
            raise NotImplementedError(
                "SampleWiseBN is not ported yet (ROADMAP Queue 1: training "
                "and the keras import)"
            )
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"unknown FCN dtype {cfg.dtype!r}")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.dtype]
        vs = cfg.vertical_stride
        wm = cfg.width_multiplier
        if cfg.batch_norm:
            self.norm = BatchNorm(in_channels)
        self.conv1 = Conv(in_channels, 4 * wm, (vs, 4))
        self.conv2 = Conv(4 * wm, 6 * wm, (vs, 2))
        self.conv3 = Conv(6 * wm, 12 * wm, (vs, 2))
        self.deconv4 = ConvTranspose(12 * wm, 16 * wm, (vs, 2))
        self.deconv5a = ConvTranspose(22 * wm, 8 * wm, (vs, 2))
        self.deconv6a = ConvTranspose(12 * wm, 2, (vs, 4))
        if cfg.use_regression:
            nreg = self.num_reg_channels
            self.deconv5b = ConvTranspose(22 * wm, nreg, (vs, 2))
            self.deconv6b = ConvTranspose(4 * wm + nreg, nreg, (vs, 4))

    @property
    def num_reg_channels(self) -> int:
        if self.cfg.head == "corner":
            return self.cfg.num_corner_outputs
        if self.cfg.yaw_codec == "dual":
            return DIRECT_CHANNELS_DUAL
        return DIRECT_CHANNELS

    def _trunk(self, x: torch.Tensor):
        """Shared encoder and the deconv6a head, NCHW in the compute
        dtype. The crops follow the input width, so the lidar (1801,
        conv1 width 451, crop5 = 1), camera (1368, conv1 width 343,
        crop5 = 1, 1372 cropped to 1368) and BEV (1197, conv1 width 300,
        crop5 = 0) geometries all come out at the input's width."""
        cfg = self.cfg
        w = x.shape[2]
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        if cfg.batch_norm:
            x = self.norm(x)
        x = F.pad(x, (0, 3)).to(self.compute_dtype)

        c1 = F.relu(self.conv1(x))
        c2 = F.relu(self.conv2(c1))
        c3 = F.relu(self.conv3(c2))
        d4 = F.relu(self.deconv4(c3))
        cat4 = torch.cat([c2, d4], dim=1)
        crop5 = 2 * c2.shape[3] - c1.shape[3]  # 1 when conv1 width is odd

        d5a = F.relu(self.deconv5a(cat4))[:, :, :, crop5:]
        d6a = self.deconv6a(torch.cat([c1, d5a], dim=1))[:, :, :, :w]
        return d6a, (c1, cat4, crop5, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) float32 -> (B, H, W, 2 [+ reg]) float32."""
        cfg = self.cfg
        d6a, (c1, cat4, crop5, w) = self._trunk(x)
        probs = torch.softmax(d6a.float(), dim=1).clamp(_KERAS_EPSILON, 1.0)
        if not cfg.use_regression:
            return probs.permute(0, 2, 3, 1).contiguous()

        d5b = F.relu(self.deconv5b(cat4))[:, :, :, crop5:]
        d6b = self.deconv6b(torch.cat([c1, d5b], dim=1))[:, :, :, :w]
        if cfg.head == "corner" and cfg.reg_output_activation == "relu":
            d6b = F.relu(d6b)  # reference-compat; direct targets are signed
        return torch.cat([probs, d6b.float()], dim=1).permute(0, 2, 3, 1).contiguous()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> the pre-softmax deconv6a map (B, H', W, 2) in
        the compute dtype, NHWC: the tap the fusion net consumes. H' is H
        for vertical_stride 1 and for heights the three vertical strides
        divide (the camera's 512 at stride 2)."""
        return self._trunk(x)[0].permute(0, 2, 3, 1)
