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
    FCN_PROB_ATOL,
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
GOLDEN_FUSION = os.path.join(REPO, "tests", "data", "torch_port_golden_fusion.npz")
GOLDEN_TRAIN = os.path.join(REPO, "tests", "data", "torch_port_golden_train.npz")
GOLDEN_VIEWER = os.path.join(REPO, "tests", "data", "torch_port_golden_viewer.npz")
GOLDEN_BENCH = os.path.join(REPO, "tests", "data", "torch_port_golden_bench.npz")
GOLDEN_PACKED = os.path.join(REPO, "tests", "data", "torch_port_golden_packed.npz")
GOLDEN_F8_GRAD = os.path.join(REPO, "tests", "data", "torch_port_golden_f8_grad.npz")
GOLDEN_BF16 = os.path.join(REPO, "tests", "data", "torch_port_golden_bf16.npz")
GOLDEN_F16 = os.path.join(REPO, "tests", "data", "torch_port_golden_f16.npz")
GOLDEN_F8 = os.path.join(REPO, "tests", "data", "torch_port_golden_f8.npz")
GOLDEN_F8_MESH = os.path.join(REPO, "tests", "data", "torch_port_golden_f8_mesh.npz")
FUSION_ASSET = os.path.join(ASSETS, "fusion_net.npz")
GOLDEN_SEED = 11  # JAX PRNGKey of the golden frames

# tolerances (stated once, used by every golden test)
FCN_REG_ATOL = 1e-4  # metre-scale regression channels (|x| up to ~7)
POSE_ATOL = 1e-4  # decoded poses (the tolerance __graft_entry__.py uses)
# the float32 FCN's probabilities: FCN_PROB_ATOL (1e-5); bf16 FCN against
# JAX's bf16 FCN: BF16_PROB_ATOL (2**-8) and BF16_REG_ATOL (2**-4); all
# stated in tpufusion_torch/_golden.py
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


def jax_module_from_arrays(build, arrays: dict[str, np.ndarray]):
    """The nnx module `build()` makes, holding npz-style `arrays` ('/'-
    joined state paths) as float32. Built abstract and filled (what
    tpufusion.models.io.load_state_npz stores, without the random init,
    which costs ~10 s of eager CPU ops a network). RNG state (dropout
    keys) stays abstract: inference never reads it."""
    import jax.numpy as jnp
    from flax import nnx

    graphdef, learned, rest = nnx.split(
        nnx.eval_shape(build), nnx.Any(nnx.Param, nnx.BatchStat), ...
    )
    pure: dict = {}
    for key, value in arrays.items():
        *path, leaf = key.split("/")
        node = pure
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value, jnp.float32)
    nnx.replace_by_pure_dict(learned, pure)
    return nnx.merge(graphdef, learned, rest)


def jax_model_from_arrays(mcfg, arrays: dict[str, np.ndarray], in_channels: int = 3):
    """The JAX FCN of `mcfg` (either framework's class) holding npz-style
    `arrays`."""
    from flax import nnx

    from tpufusion.models.fcn import FCN

    mcfg = to_jax_config(mcfg)
    return jax_module_from_arrays(
        lambda: FCN(mcfg, in_channels=in_channels, rngs=nnx.Rngs(0)), arrays
    )


def jax_apply(model, fn, *args):
    """fn(model, *args) under jit with the model's learned state as an
    argument (eager nnx runs op by op); the result's leaves as numpy."""
    import jax
    from flax import nnx

    graphdef, learned, rest = nnx.split(model, nnx.Any(nnx.Param, nnx.BatchStat), ...)
    out = jax.jit(lambda st, *a: fn(nnx.merge(graphdef, st, rest), *a))(learned, *args)
    return jax.tree.map(np.asarray, out)


def random_arrays(module: torch.nn.Module, seed: int) -> dict[str, np.ndarray]:
    """npz-style float32 arrays for every entry of a port module's state,
    from a numpy seed: kernels U(-0.05, 0.05) (the reference's init),
    biases U(-0.5, 0.5), BatchNorm statistics away from the identity."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in module.state_dict().items():
        shape = tuple(t.shape)
        if key.endswith("kernel"):
            v = rng.uniform(-0.05, 0.05, shape)
        elif key.endswith(("norm.var", "norm.scale")):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.uniform(-0.5, 0.5, shape)
        out[key.replace(".", "/")] = v.astype(np.float32)
    return out


def jax_asset_model(asset: str = ASSET, dtype: str = "float32"):
    """The JAX FCN with an asset's weights, computing in `dtype`."""
    mcfg, _ = asset_configs(asset)
    return jax_model_from_arrays(
        dataclasses.replace(mcfg, dtype=dtype), load_npz(asset)
    )


def jax_forward(model, images: np.ndarray) -> np.ndarray:
    """The JAX FCN's inference output, jitted (eager nnx runs op by op)."""
    return np.array(jax_apply(model, lambda m, x: m(x, train=False), images))


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
    numpy points (`valid` may be None) -> (poses, found) as numpy; `dcfg`
    in either framework's class."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.config import RangeViewSpec
    from tpufusion.predict import make_e2e_step

    graphdef, state = nnx.split(model)
    step = make_e2e_step(
        graphdef, RangeViewSpec(), to_jax_config(dcfg), max_obstacles=k, head=head
    )
    poses, found = step(
        state, jnp.asarray(points), None if valid is None else jnp.asarray(valid)
    )
    return np.asarray(poses), np.asarray(found)


def image_digest(image: np.ndarray) -> str:
    """sha256 of one (H, W, 3) float32 image's bytes."""
    return hashlib.sha256(np.ascontiguousarray(image, np.float32).tobytes()).hexdigest()


def occupied_pixels(image: np.ndarray, min_height: float = -2.0) -> int:
    """Pixels that differ from the empty fill (0, min_height, 0)."""
    fill = np.array([0.0, min_height, 0.0], np.float32)
    return int((image != fill).any(axis=-1).sum())


SHIPPED_LAYERS = {  # the shipped lidar_model.h5's layers: (kernel shape as Keras stores it)
    "conv1": (5, 5, 3, 4), "conv2": (5, 5, 4, 6), "conv3": (5, 5, 6, 12),
    "deconv4": (5, 5, 16, 12), "deconv5a": (5, 5, 8, 22), "deconv6a": (5, 5, 2, 12),
}


def write_shipped_h5(path, image_hw: tuple[int, int], seed: int, extra_layer: str | None = None,
                     positions: int | None = None) -> None:
    """A Keras-2-style weights file with the shipped model's layout (one
    group a layer at the root, datasets `<layer>/<layer>/<name>:0`) and
    seeded weights: range-view-scale normalize statistics, kernels
    U(-0.1, 0.1), biases U(-0.1, 0.1). `extra_layer` adds a layer the
    shipped file lacks (a regression head's "deconv5b"); `positions`
    overrides the normalize length."""
    import h5py

    rng = np.random.default_rng(seed)
    n = positions or image_hw[0] * image_hw[1]
    layers = {"normalize": {"gamma": rng.uniform(0.5, 1.5, n), "beta": rng.uniform(-0.5, 0.5, n),
                            "moving_mean": rng.uniform(0.0, 40.0, n),
                            "moving_variance": rng.uniform(100.0, 900.0, n)}}
    for name, shape in SHIPPED_LAYERS.items():
        outputs = shape[2] if name.startswith("deconv") else shape[3]  # Keras: (kh, kw, out, in) for a deconv
        layers[name] = {"kernel": rng.uniform(-0.1, 0.1, shape), "bias": rng.uniform(-0.1, 0.1, outputs)}
    if extra_layer:
        layers[extra_layer] = dict(layers["deconv5a"])
    with h5py.File(path, "w") as f:
        for layer, weights in layers.items():
            g = f.create_group(layer).create_group(layer)
            for name, v in weights.items():
                g.create_dataset(f"{name}:0", data=np.asarray(v, np.float32))


def range_view_inputs(seed: int, batch: int, width: int) -> np.ndarray:
    """Range-view-like images (B, 32, width, 3): distances, heights, intensities."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 90, (batch, 32, width)), rng.uniform(-2, 2, (batch, 32, width)),
                     rng.uniform(0, 100, (batch, 32, width))], axis=-1).astype(np.float32)


def label_prepared(seed: int, n_batches: int, batch: int, spec, head: str = "direct",
                   yaw_frame: str = "global", scenes: str = "beam", max_yaw: float = 0.05,
                   n_points: int = 8192):
    """Prepared eval batches as the detector tools make them, [(predictions,
    images, gt)] with port tensors on the CPU, whose predictions are the
    labels of each frame's own ground truth (the head's codec) with seeded
    noise: foreground probability ~0.95 on the label's footprint, ~0.02
    off it, regression targets within 0.05. Every decode finds clusters
    on them, which a random FCN's maps would not give. Scenes from numpy
    seeds seed, seed + 1, ..."""
    from tpufusion_torch.geometry.encoding import encode_direct_label_batch, encode_label_batch
    from tpufusion_torch.geometry.range_view import range_view_project_batch
    from tpufusion_torch.tools.train_synthetic_detector import _synth

    noise = np.random.default_rng(seed + 10_000)
    prepared = []
    for b in range(n_batches):
        pts, gt, valid = _synth(scenes, np.random.default_rng(seed + b), batch, n_points, max_yaw)
        images = range_view_project_batch(torch.from_numpy(pts), spec, torch.from_numpy(valid))
        args = [torch.from_numpy(gt[k]) for k in ("center", "size", "yaw")] + [images, spec]
        if head == "direct":
            labels = encode_direct_label_batch(*args, yaw_frame=yaw_frame)
        else:
            labels = encode_label_batch(*args)
        labels = labels.numpy()
        fg = labels[..., 1] > 0.5
        prob = np.where(fg, 0.95, 0.02) + noise.uniform(-0.02, 0.02, fg.shape)
        reg = labels[..., 2:] + noise.uniform(-0.05, 0.05, labels[..., 2:].shape) * fg[..., None]
        preds = np.concatenate([(1 - prob)[..., None], prob[..., None], reg], -1).astype(np.float32)
        prepared.append((torch.from_numpy(preds), images, gt))
    return prepared


def jax_prepared(prepared):
    """`label_prepared`'s batches as the JAX tools take them (jax arrays)."""
    import jax.numpy as jnp

    return [(jnp.asarray(p.numpy()), jnp.asarray(i.numpy()), gt) for p, i, gt in prepared]
