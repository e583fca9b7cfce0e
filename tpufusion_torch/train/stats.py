"""Population statistics feeding the class-balanced loss (counterpart of
`tpufusion/train/stats.py`): the footprint areas of all ground-truth
poses come from one batched call on the device; no image is read, since
the footprint depends on the pose alone."""

from __future__ import annotations

import numpy as np
import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.encoding import footprint_mask

_CHUNK = 256  # poses per footprint call: (256, 32, 1801) float32 is 59 MB


def population_weights(
    centers: np.ndarray,  # (F, 3)
    sizes: np.ndarray,  # (F, 3)
    yaws: np.ndarray,  # (F,)
    spec: RangeViewSpec = RangeViewSpec(),
    device: torch.device | str = "cuda",
) -> dict[str, float]:
    """positive_to_negative_ratio and average_area over the dataset;
    frames with an empty footprint are left out of the averages. The
    footprints are painted on `device` (the card unless the caller asks
    for "cpu")."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    c, s, y = put(centers), put(sizes), put(yaws)
    with torch.no_grad():
        areas = torch.cat([
            footprint_mask(c[lo:lo + _CHUNK], s[lo:lo + _CHUNK], y[lo:lo + _CHUNK], spec)
            .sum(dim=(-2, -1))
            for lo in range(0, len(c), _CHUNK)
        ]).cpu().numpy()
    total_px = spec.height * spec.width
    nonempty = areas > 0
    positive = float(areas[nonempty].sum())
    samples = float(total_px * nonempty.sum())
    count = int(nonempty.sum())
    if count == 0:
        return {"positive_to_negative_ratio": 0.0, "average_area": 0.0}
    return {
        "positive_to_negative_ratio": positive / (samples - positive),
        "average_area": positive / count,
    }
