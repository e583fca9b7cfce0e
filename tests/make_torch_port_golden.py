"""Writes tests/data/torch_port_golden.npz: the JAX main path's answer on
two beam-scan frames, for checking the PyTorch port where JAX is not
installed (chip_smoke.py holds the port on the GPU against it).

The file holds the points themselves (numpy's vectorised trigonometry may
differ by ulps between CPUs, so they are stored, not regenerated), their
validity mask, the JAX e2e `found` and poses with the shipped detector
asset, and each frame's JAX range-view image as a sha256 and an
occupied-pixel count. tests/test_torch_e2e.py recomputes all of it and
fails when the file is stale.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py
"""

from __future__ import annotations

import os
import sys

import numpy as np


def golden_arrays() -> dict[str, np.ndarray]:
    from tests.torch_golden import (
        GOLDEN_SEED,
        image_digest,
        jax_beam_scans,
        jax_e2e,
        occupied_pixels,
    )

    points, valid = jax_beam_scans(GOLDEN_SEED, 2)
    poses, found, images = jax_e2e(points, valid)
    return {
        "points": points,
        "valid": valid,
        "found": found.astype(bool),
        "poses": poses.astype(np.float32),
        "image_sha256": np.array([image_digest(im) for im in images]),
        "occupied": np.array([occupied_pixels(im) for im in images], np.int64),
    }


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.torch_golden import GOLDEN

    arrays = golden_arrays()
    if not arrays["found"].all():
        raise SystemExit(f"golden frames must all be detections: {arrays['found']}")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: found {arrays['found']}, occupied {arrays['occupied']}")


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
