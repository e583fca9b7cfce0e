"""Small constant tensors on the device, made once per (values, dtype,
device) and kept: `torch.tensor(values, device="cuda")` copies from
pageable host memory and ends in `cudaStreamSynchronize`, so the host
would wait for the card every call. Only the first call copies."""

from __future__ import annotations

import functools
import math

import torch


@functools.lru_cache(maxsize=None)
def _cached(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):  # a normal tensor, usable in and out of inference mode
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The 1-D tensor of `values` on `device`, shared by every caller:
    read it, never write it."""
    return _cached(tuple(float(v) for v in values), dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached_scalar(bits: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.full((), bits[0], dtype=dtype, device=device)


def device_scalar(value: float, dtype: torch.dtype, device) -> torch.Tensor:
    """The 0-d tensor of `value` on `device`, made by a fill (no host
    copy) and shared by every caller: read it, never write it. -0.0 and
    0.0 are two constants."""
    value = float(value)
    return _cached_scalar((value, math.copysign(1.0, value)), dtype, torch.device(device))
