"""Shared helpers for the PyTorch port's golden tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package (on the CPU, as
tests/conftest.py forces) and through its counterpart in
`tpufusion_torch`; arrays cross between the two as numpy, and configs
through `to_jax_config` / `to_port_config`, so each framework gets its
own config classes. JAX is imported inside the functions that need it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from tpufusion_torch._golden import (  # noqa: F401  (re-exported)
    BF16_PROB_ATOL,
    BF16_REG_ATOL,
    load_npz,
    wrapped_pose_diff,
)
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "tpufusion", "assets")
ASSET = os.path.join(ASSETS, "synthetic_detector.npz")
MIXED_ASSET = os.path.join(ASSETS, "synthetic_detector_mixed.npz")
YAW_ASSET = os.path.join(ASSETS, "synthetic_detector_yaw.npz")
GOLDEN = os.path.join(REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(REPO, "tests", "data", "torch_port_golden_multi.npz")
GOLDEN_SEED = 11  # JAX PRNGKey of the golden frames

# tolerances (stated once, used by every golden test)
FCN_PROB_ATOL = 1e-5  # the two softmax probabilities
FCN_REG_ATOL = 1e-4  # metre-scale regression channels (|x| up to ~7)
POSE_ATOL = 1e-4  # decoded poses (the tolerance __graft_entry__.py uses)
# bf16 FCN against JAX's bf16 FCN: BF16_PROB_ATOL (2**-8) and
# BF16_REG_ATOL (2**-4), stated in tpufusion_torch/_golden.py
# poses decoded from the bf16 FCN's output: they read 3.8e-6 against
# JAX's bf16 answers on the CPU and on an H100; rounding each bf16
# convolution once instead of twice (a fault) moves them 3.7e-3
BF16_POSE_ATOL = 1e-3

# Under xdist, each worker's torch would start one thread per core and the
# workers would oversubscribe the CPU; give each worker its share instead.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


def _convert(cfg, module):
    cls = getattr(module, type(cfg).__name__)
    kw = dataclasses.asdict(cfg)
    for f in dataclasses.fields(cls):
        value = getattr(cfg, f.name)
        if dataclasses.is_dataclass(value):  # asdict made it a dict
            kw[f.name] = _convert(value, module)
    return cls(**kw)


def to_jax_config(cfg):
    """A config dataclass (nested ones included) as the JAX package's
    class of the same name, field by field."""
    import tpufusion.config

    return _convert(cfg, tpufusion.config)


def to_port_config(cfg):
    """A config dataclass (nested ones included) as the port's class of
    the same name, field by field."""
    import tpufusion_torch.config

    return _convert(cfg, tpufusion_torch.config)


def asset_configs(asset: str = ASSET):
    """(ModelConfig, DecodeConfig) of a shipped detector asset, from its
    json, as the JAX benchmarks read it (float32 FCN here), in the port's
    classes."""
    return models_io.asset_configs(asset)


def port_asset_model(asset: str = ASSET, dtype: str = "float32"):
    """The port's FCN with an asset's weights, computing in `dtype`."""
    mcfg, _ = asset_configs(asset)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype))
    models_io.load_state_npz(asset, model)
    return model.eval()


def jax_model_from_arrays(mcfg, arrays: dict[str, np.ndarray]):
    """The JAX FCN of `mcfg` (either framework's class) holding npz-style
    `arrays`. Built abstract and filled (what
    tpufusion.models.io.load_state_npz stores, without its random init,
    which costs ~10 s of eager CPU ops)."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.models.fcn import FCN

    mcfg = to_jax_config(mcfg)
    graphdef, state = nnx.split(
        nnx.eval_shape(lambda: FCN(mcfg, in_channels=3, rngs=nnx.Rngs(0)))
    )
    pure: dict = {}
    for key, value in arrays.items():
        layer, leaf = key.split("/")
        pure.setdefault(layer, {})[leaf] = jnp.asarray(value)
    nnx.replace_by_pure_dict(state, pure)
    return nnx.merge(graphdef, state)


def jax_asset_model(asset: str = ASSET, dtype: str = "float32"):
    """The JAX FCN with an asset's weights, computing in `dtype`."""
    mcfg, _ = asset_configs(asset)
    return jax_model_from_arrays(
        dataclasses.replace(mcfg, dtype=dtype), load_npz(asset)
    )


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

    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.range_view import range_view_project_batch

    _, dcfg = asset_configs()
    poses, found = jax_step(jax_asset_model(), dcfg, points, valid)
    images = range_view_project_batch(
        jnp.asarray(points), RangeViewSpec(), jnp.asarray(valid), "exact"
    )
    return poses, found, np.asarray(images)


def jax_step(model, dcfg, points, valid, k: int = 1, head: str = "direct"):
    """JAX make_e2e_step(model, dcfg, max_obstacles=k, head=head) on
    numpy points -> (poses, found) as numpy; `dcfg` in either framework's
    class."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.config import RangeViewSpec
    from tpufusion.predict import make_e2e_step

    graphdef, state = nnx.split(model)
    step = make_e2e_step(
        graphdef, RangeViewSpec(), to_jax_config(dcfg), max_obstacles=k, head=head
    )
    poses, found = step(state, jnp.asarray(points), jnp.asarray(valid))
    return np.asarray(poses), np.asarray(found)


def image_digest(image: np.ndarray) -> str:
    """sha256 of one (H, W, 3) float32 image's bytes."""
    return hashlib.sha256(np.ascontiguousarray(image, np.float32).tobytes()).hexdigest()


def occupied_pixels(image: np.ndarray, min_height: float = -2.0) -> int:
    """Pixels that differ from the empty fill (0, min_height, 0)."""
    fill = np.array([0.0, min_height, 0.0], np.float32)
    return int((image != fill).any(axis=-1).sum())
