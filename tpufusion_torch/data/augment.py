"""Azimuth-roll augmentation on the device (counterpart of
`tpufusion/data/augment.py`).

The reference rolls each frame (image and label) by a random number of
columns and rejects rolls that would split the object across the 360
degree wrap. The invalid shifts form one interval [W - lr_x, W - ul_x], so
a uniform draw over [0, W - n_invalid) mapped around that interval is the
same distribution without the rejection loop. A batch is rolled with one
gather along the width. Random draws come from the `torch.Generator` the
caller passes (on the CPU or on the card); its draws differ from
`jax.random`'s, so `augment_batch` also takes the shifts themselves. On a
mesh every rank draws the global batch's uniforms from the same seeded
generator and keeps its data row's rows, so the sharded step rolls each
frame as the one-process step does (the ranks of a row alike).
"""

from __future__ import annotations

import math

import torch

from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.boxes import outer_rect


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    """U[0, 1) float64 drawn on the generator's device, moved to `device`."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float64)
    return u.to(device)


def sample_roll(
    generator: torch.Generator,
    center: torch.Tensor,  # (..., 3)
    size: torch.Tensor,  # (..., 3)
    yaw: torch.Tensor,  # (...)
    spec: RangeViewSpec,
    mesh=None,
) -> torch.Tensor:
    """(...) int64 shifts, uniform over the shifts that keep the object's
    outer rect whole. On a `mesh` the leading axis is this rank's data
    row's rows of the global batch."""
    w = spec.width
    ul_x, _, lr_x, _ = outer_rect(center, size, yaw, spec)
    lo = torch.clamp(w - lr_x, 0, w).to(torch.int64)  # first invalid shift
    hi = torch.maximum(torch.clamp(w - ul_x + 1, max=w).to(torch.int64), lo)  # one past the last
    n_invalid = hi - lo
    n_valid = torch.clamp(w - n_invalid, min=1)
    if mesh is None:
        u = _uniform(generator, lo.shape, lo.device)
    else:  # the global batch's draws, this rank's rows
        b = lo.shape[0]
        u = _uniform(generator, (mesh.n_data * b, *lo.shape[1:]), lo.device)
        u = u[mesh.data_index * b : (mesh.data_index + 1) * b]
    k = torch.minimum(torch.floor(u * n_valid).to(torch.int64), n_valid - 1)
    return torch.where(k < lo, k, k + n_invalid)


def roll_frame(image: torch.Tensor, label: torch.Tensor, shift):
    """Roll (..., H, W, C) tensors along the azimuth axis by `shift`
    columns, one shift per leading index (`jnp.roll` per frame): column c
    of the result is column (c - shift) mod W of the input."""
    w = image.shape[-2]
    shift = torch.as_tensor(shift, device=image.device)
    src = torch.remainder(
        torch.arange(w, device=image.device) - shift[..., None], w
    )  # (..., W)

    def roll(x):
        idx = src[..., None, :, None].expand(x.shape)
        return torch.gather(x, -2, idx)

    return roll(image), roll(label)


def transform_point_cloud(
    generator: torch.Generator,
    points: torch.Tensor,  # (N, >=3)
    max_rotation: float = math.pi,
    max_translation: float = 3.0,
):
    """A random z-rotation and xy-translation of a cloud:
    (points', (angle, tx, ty))."""
    u = _uniform(generator, (3,), points.device).to(torch.float32)
    angle = (2.0 * u[0] - 1.0) * max_rotation
    txy = (2.0 * u[1:] - 1.0) * max_translation
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[:, 0] * c - points[:, 1] * s + txy[0]
    y = points[:, 0] * s + points[:, 1] * c + txy[1]
    return torch.cat([x[:, None], y[:, None], points[:, 2:]], dim=1), (angle, txy[0], txy[1])


def augment_batch(
    generator: torch.Generator | None,
    images: torch.Tensor,  # (B, H, W, C)
    labels: torch.Tensor,  # (B, H, W, 26)
    centers: torch.Tensor,
    sizes: torch.Tensor,
    yaws: torch.Tensor,
    spec: RangeViewSpec,
    shifts: torch.Tensor | None = None,
    mesh=None,
):
    """Rolls every frame of the batch by its own valid shift. `shifts`
    (B,) given, they are used as they are and nothing is drawn."""
    if shifts is None:
        shifts = sample_roll(generator, centers, sizes, yaws, spec, mesh)
    return roll_frame(images, labels, shifts)
