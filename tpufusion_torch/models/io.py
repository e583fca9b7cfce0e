"""npz weight loading and saving (counterpart of `tpufusion/models/io.py`),
the detector assets' json settings and the fusion asset's loader.

Keys are the '/'-joined nnx state paths the JAX package writes and reads
(`conv1/kernel`, `norm/mean`, ...), which are also this FCN's state-dict
keys with '.' for '/': a model trained by either package loads into the
other. A missing or extra key raises, as in JAX. `optimizer_arrays` /
`optimizer_from_arrays` carry Adam's step count and moments as numpy
arrays keyed like the parameters.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpufusion_torch.config import CameraConfig, DecodeConfig, ModelConfig
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.fusion import FusionNet


def load_arrays(model: torch.nn.Module, arrays: dict[str, np.ndarray]) -> None:
    """Copy npz-style arrays into `model` in place (shapes must match)."""
    state = model.state_dict()
    keys = {k.replace(".", "/") for k in state}
    mismatch = keys.symmetric_difference(arrays)
    if mismatch:
        raise ValueError(f"state/file key mismatch: {sorted(mismatch)[:6]}")
    with torch.no_grad():
        for k, t in state.items():
            v = np.asarray(arrays[k.replace(".", "/")])
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {v.shape} != model {tuple(t.shape)}")
            t.copy_(torch.tensor(v, dtype=torch.float32))


def fcn_from_arrays(
    arrays: dict[str, np.ndarray],
    cfg: ModelConfig,
    in_channels: int = 3,
    device: torch.device | str = "cuda",
) -> FCN:
    """The FCN of `cfg` holding npz-style `arrays`, on `device` (the card
    unless the caller asks for "cpu"; without a card that raises)."""
    model = FCN(cfg, in_channels)
    load_arrays(model, arrays)
    return model.to(device).eval()


def load_state_npz(path: str, model: torch.nn.Module) -> None:
    """Loads weights saved by tpufusion.models.io.save_state_npz."""
    with np.load(path) as z:
        load_arrays(model, {k: z[k] for k in z.files})


def state_arrays(model: torch.nn.Module) -> dict[str, np.ndarray]:
    """Every learned entry of `model` (parameters and batch statistics) as
    numpy arrays under the '/'-joined keys."""
    return {k.replace(".", "/"): v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def save_state_npz(path: str, model: torch.nn.Module, dtype=None) -> None:
    """Writes the single-file npz that `load_state_npz` of either package
    reads. `dtype` (e.g. np.float16) downcasts the stored floating arrays;
    loading casts back to float32."""
    arrays = state_arrays(model)
    if dtype is not None:
        arrays = {
            k: v.astype(dtype) if np.issubdtype(v.dtype, np.floating) else v
            for k, v in arrays.items()
        }
    np.savez_compressed(path, **arrays)


def optimizer_arrays(optimizer, model: torch.nn.Module) -> dict[str, np.ndarray]:
    """`train.optim.Adam`'s state as numpy: "count", and "mu/<key>" and
    "nu/<key>" for every parameter of `model` it has moments for."""
    out = {"count": np.asarray(optimizer.count, np.int64)}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if state:
            key = name.replace(".", "/")
            out[f"mu/{key}"] = state["mu"].detach().cpu().numpy()
            out[f"nu/{key}"] = state["nu"].detach().cpu().numpy()
    return out


def optimizer_from_arrays(optimizer, model: torch.nn.Module, arrays: dict[str, np.ndarray]) -> None:
    """The inverse of `optimizer_arrays`: fills the optimizer's count and
    the moments of every parameter of `model` that `arrays` holds."""
    optimizer.count = int(arrays["count"])
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        if f"mu/{key}" in arrays:
            state = optimizer._state(p)
            for moment in ("mu", "nu"):
                state[moment].copy_(torch.as_tensor(arrays[f"{moment}/{key}"], dtype=p.dtype))


def asset_configs(path: str) -> tuple[ModelConfig, DecodeConfig]:
    """A detector asset's settings: the "model" and "decode" entries of
    `path + ".json"` over the config defaults (as the reference's
    benchmarks read them)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    return (
        dataclasses.replace(ModelConfig(), **meta.get("model", {})),
        dataclasses.replace(DecodeConfig(), **meta.get("decode", {})),
    )


def fusion_from_asset(
    path: str,
    device: torch.device | str = "cuda",
    dtype: str = "bfloat16",
) -> FusionNet:
    """The fusion net of a shipped asset: weights `path` (.npz, float16
    or float32, cast to float32 parameters) plus `path + ".json"`, which
    names the pools (`lidar_pool`, `cam_pool`) and the camera's width and
    height. Both FCNs compute in `dtype` (bf16, as the reference's fused
    benchmark builds them). The net is moved to `device` (the card unless
    the caller asks for "cpu"). An unreadable asset, a missing entry or
    any key or shape mismatch raises: there is no fall-back to random
    weights."""
    with open(path + ".json") as f:
        meta = json.load(f)
    cam = meta.get("camera", {})
    camera = dataclasses.replace(
        CameraConfig(), **{k: int(cam[k]) for k in ("width", "height") if k in cam}
    )
    net = FusionNet(
        lidar_model=ModelConfig(dtype=dtype),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype=dtype),
        camera=camera,
        lidar_pool=tuple(meta["lidar_pool"]),
        cam_pool=tuple(meta["cam_pool"]),
    )
    load_state_npz(path, net)
    return net.to(device).eval()
