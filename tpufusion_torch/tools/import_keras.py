"""Import the reference's shipped Keras weights into the port (counterpart
of `tpufusion/tools/import_keras.py`).

The reference ships a trained classification model
(`modules/lidar/data/lidar_model.h5`, Keras 2.0.4): sample-wise BN +
conv1..3 + deconv4/5a/6a. `load_reference_fcn` maps those weights onto
`ShippedLidarFCN`, the shipped network's own graph built from the port's
`Conv`, `ConvTranspose` and `SampleWiseBN`.

Kernel conventions:
  * Conv2D: Keras (kh, kw, in, out) is flax's HWIO, which the port's
    layers keep: copied as-is.
  * Conv2DTranspose: Keras stores (kh, kw, out, in) and computes the
    GRADIENT of a strided conv; flax's ConvTranspose (transpose_kernel=
    False), and the port's after it, compute a fractionally-strided conv
    with (kh, kw, in, out). The two agree iff the Keras kernel is
    spatially flipped and its channel axes swapped
    (`keras_deconv_to_flax`).

`h5py` is imported where a file is read: the importer runs on the host,
and the card's machine need not have it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpufusion_torch.models.fcn import _KERAS_EPSILON, Conv, ConvTranspose, SampleWiseBN


def keras_deconv_to_flax(kernel: np.ndarray) -> np.ndarray:
    """(kh, kw, out, in) gradient-conv kernel -> flax (kh, kw, in, out)."""
    return kernel[::-1, ::-1].transpose(0, 1, 3, 2).copy()


def _weights_of(f, layer: str) -> dict[str, np.ndarray]:
    import h5py

    out = {}

    def visit(name, item):
        if isinstance(item, h5py.Dataset):
            out[name.split("/")[-1].split(":")[0]] = np.asarray(item)

    f[layer].visititems(visit)
    return out


class ShippedLidarFCN(nn.Module):
    """The graph of the shipped `lidar_model.h5` (wiring from its
    `lidar_model.json`): sample-wise BN -> zero-pad width (0, 3) -> conv1
    4ch 5x5 s(2, 4) SAME -> conv2 6ch s(2, 2) VALID -> conv3 12ch s(2, 2)
    VALID -> deconv4 16ch s(2, 2) VALID, pad ((1, 0), (0, 1)), concat
    conv2 -> deconv5a 8ch s(2, 2) VALID, pad ((1, 0), (0, 0)), concat
    conv1 -> deconv6a 2ch s(2, 4) SAME -> crop the width -> softmax ->
    clip. An older architecture than the reference's current model.py
    (vertical stride 1, SAME everywhere): the artifact predates it.
    Parameters are float32 and the graph runs in float32."""

    def __init__(self, in_channels: int = 3, image_hw: tuple[int, int] = (32, 1801)):
        super().__init__()
        self.norm = SampleWiseBN(image_hw[0] * image_hw[1])
        self.conv1 = Conv(in_channels, 4, (2, 4), "SAME")
        self.conv2 = Conv(4, 6, (2, 2), "VALID")
        self.conv3 = Conv(6, 12, (2, 2), "VALID")
        self.deconv4 = ConvTranspose(12, 16, (2, 2), "VALID")
        self.deconv5a = ConvTranspose(22, 8, (2, 2), "VALID")
        self.deconv6a = ConvTranspose(12, 2, (2, 4), "SAME")

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """(B, H, W, C) float32 -> class probabilities (B, H, W, 2)."""
        w = x.shape[2]
        x = self.norm(x.to(torch.float32).permute(0, 3, 1, 2), train)
        x = F.pad(x, (0, 3))
        c1 = F.relu(self.conv1(x))
        c2 = F.relu(self.conv2(c1))
        c3 = F.relu(self.conv3(c2))
        d4 = F.pad(F.relu(self.deconv4(c3)), (0, 1, 1, 0))  # height (1, 0), width (0, 1)
        d5 = F.relu(self.deconv5a(torch.cat([c2, d4], dim=1)))
        d5 = F.pad(d5, (0, 0, 1, 0))  # height (1, 0)
        d6 = self.deconv6a(torch.cat([c1, d5], dim=1))[:, :, :, :w]
        probs = torch.softmax(d6, dim=1).clamp(_KERAS_EPSILON, 1.0)
        return probs.permute(0, 2, 3, 1).contiguous()


def load_reference_fcn(
    h5_path: str,
    image_hw: tuple[int, int] = (32, 1801),
    in_channels: int = 3,
    device: torch.device | str = "cuda",
) -> ShippedLidarFCN:
    """The shipped weights in the ShippedLidarFCN graph, on `device` (the
    card unless the caller asks for "cpu"). Raises ValueError for a
    regression-head file (not the shipped layout) and for a normalize
    layer whose length is not image_hw's number of positions."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        layers = set()
        f.visit(lambda n: layers.add(n.split("/")[0]))
        if "deconv5b" in layers:
            raise ValueError("regression-head h5 is not the shipped artifact layout")
        norm_w = _weights_of(f, "normalize")
        if norm_w["gamma"].size != image_hw[0] * image_hw[1]:
            raise ValueError(
                f"normalize has {norm_w['gamma'].size} positions, expected "
                f"{image_hw[0] * image_hw[1]} (sample-wise BN)"
            )
        model = ShippedLidarFCN(in_channels, image_hw)
        state = {"norm.scale": norm_w["gamma"], "norm.bias": norm_w["beta"],
                 "norm.mean": norm_w["moving_mean"], "norm.var": norm_w["moving_variance"]}
        for name in ("conv1", "conv2", "conv3"):
            w = _weights_of(f, name)
            state.update({f"{name}.kernel": w["kernel"], f"{name}.bias": w["bias"]})
        for name in ("deconv4", "deconv5a", "deconv6a"):
            w = _weights_of(f, name)
            state.update({f"{name}.kernel": keras_deconv_to_flax(w["kernel"]), f"{name}.bias": w["bias"]})
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()})
    return model.to(device)
