"""npz weight loading (counterpart of `tpufusion/models/io.py`) and the
detector assets' json settings.

Keys are the '/'-joined nnx state paths the JAX package writes
(`conv1/kernel`, `norm/mean`, ...), which are also this FCN's state-dict
keys with '.' for '/'. A missing or extra key raises, as in JAX.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from tpufusion_torch.config import DecodeConfig, ModelConfig
from tpufusion_torch.models.fcn import FCN


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
    arrays: dict[str, np.ndarray], cfg: ModelConfig, in_channels: int = 3
) -> FCN:
    model = FCN(cfg, in_channels)
    load_arrays(model, arrays)
    return model.eval()


def load_state_npz(path: str, model: torch.nn.Module) -> None:
    """Loads weights saved by tpufusion.models.io.save_state_npz."""
    with np.load(path) as z:
        load_arrays(model, {k: z[k] for k in z.files})


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
