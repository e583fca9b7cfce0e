"""Shared helpers for the PyTorch port's golden tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package (on the CPU, as
tests/conftest.py forces) and through its counterpart in
`tpufusion_torch`; arrays cross between the two as numpy. JAX is imported
inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(REPO, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_SEED = 11  # JAX PRNGKey of the golden frames

# tolerances (stated once, used by every golden test)
FCN_PROB_ATOL = 1e-5  # the two softmax probabilities
FCN_REG_ATOL = 1e-4  # metre-scale regression channels (|x| up to ~7)
POSE_ATOL = 1e-4  # decoded poses (the tolerance __graft_entry__.py uses)

# Under xdist, each worker's torch would start one thread per core and the
# workers would oversubscribe the CPU; give each worker its share instead.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def asset_configs():
    """(ModelConfig, DecodeConfig) of the shipped detector asset, from its
    json, as the JAX benchmarks read it (float32 FCN here)."""
    from tpufusion.config import DecodeConfig, ModelConfig

    with open(ASSET + ".json") as f:
        meta = json.load(f)
    mcfg = dataclasses.replace(ModelConfig(), **meta["model"])
    dcfg = dataclasses.replace(DecodeConfig(), **meta["decode"])
    return mcfg, dcfg


def jax_asset_model():
    """The JAX FCN with the asset's weights. Built abstract and filled from
    the npz (what tpufusion.models.io.load_state_npz stores, without its
    random init, which costs ~10 s of eager CPU ops)."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.models.fcn import FCN

    mcfg, _ = asset_configs()
    graphdef, state = nnx.split(
        nnx.eval_shape(lambda: FCN(mcfg, in_channels=3, rngs=nnx.Rngs(0)))
    )
    pure: dict = {}
    with np.load(ASSET) as z:
        for key in z.files:
            layer, leaf = key.split("/")
            pure.setdefault(layer, {})[leaf] = jnp.asarray(z[key])
    nnx.replace_by_pure_dict(state, pure)
    return nnx.merge(graphdef, state)


def jax_forward(model, images: np.ndarray) -> np.ndarray:
    """The JAX FCN's inference output, jitted (eager nnx runs op by op)."""
    import jax
    from flax import nnx

    graphdef, state = nnx.split(model)
    fwd = jax.jit(lambda st, x: nnx.merge(graphdef, st)(x, train=False))
    return np.array(fwd(state, images))


def jax_beam_scans(seed: int, batch: int, n_points: int = 32768):
    """(points (B, N, 4) float32, valid (B, N) bool) from the JAX generator."""
    import jax

    from tpufusion.data.synthetic import synthesize_beam_scan_batch

    pts, _, valid = synthesize_beam_scan_batch(
        jax.random.PRNGKey(seed), batch, n_points
    )
    return np.array(pts, np.float32), np.array(valid, bool)


def jax_e2e(points: np.ndarray, valid: np.ndarray):
    """The JAX main path (make_e2e_step, head="direct") with the asset:
    -> (poses (B, 7), found (B,), images (B, H, W, 3)) as numpy."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.predict import make_e2e_step

    _, dcfg = asset_configs()
    spec = RangeViewSpec()
    graphdef, state = nnx.split(jax_asset_model())
    step = make_e2e_step(graphdef, spec, dcfg, head="direct")
    pts, ok = jnp.asarray(points), jnp.asarray(valid)
    poses, found = step(state, pts, ok)
    images = range_view_project_batch(pts, spec, ok, "exact")
    return np.asarray(poses), np.asarray(found), np.asarray(images)


def image_digest(image: np.ndarray) -> str:
    """sha256 of one (H, W, 3) float32 image's bytes."""
    return hashlib.sha256(np.ascontiguousarray(image, np.float32).tobytes()).hexdigest()


def occupied_pixels(image: np.ndarray, min_height: float = -2.0) -> int:
    """Pixels that differ from the empty fill (0, min_height, 0)."""
    fill = np.array([0.0, min_height, 0.0], np.float32)
    return int((image != fill).any(axis=-1).sum())
