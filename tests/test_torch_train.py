"""The port's training path against the JAX package, on the CPU.

The same numpy inputs, made from seeds, go through the JAX function and
its counterpart in `tpufusion_torch`: the box geometry and label codecs,
the roll augmentation, the class-balanced loss, the metrics, the
population statistics, the FCN in training mode, the train / eval steps,
the trainer, checkpoints and the batch pipeline. Sizes are small: the
range view of `RangeViewSpec(res_h_deg=1.8)` (32 x 201, whose conv widths
round-trip), batches of 2-4 frames, 2,048 points a frame. Every entry
point is asked for device="cpu".

Tolerances (float32 on the CPU unless said): rects and footprint masks
identical; labels and decoded corners 1e-5; the loss 1e-5 relative for
every LossConfig branch; the gradients of one step 1e-4 of each tensor's
largest entry (they read ~1e-5); bf16 gradients 2**-6 for kernels and the
BatchNorm (conv biases 2**-3: see the bf16 test); BatchNorm running statistics
1e-6; a 5-step trajectory's losses 1e-3 relative. Adam's first step moves
every entry by lr whatever the gradient's size, so parameters are never
compared after a step taken from independently computed gradients: the
optimizer is compared on identical gradients (tests/test_torch_optim.py)
and a trajectory by its losses.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

import tpufusion.config as jax_config
from tests.torch_golden import (
    ASSET,
    GOLDEN_MULTI,
    GOLDEN_TRAIN,
    jax_model_from_arrays,
    load_npz,
    random_arrays,
    to_jax_config,
)
from tpufusion.data import augment as jax_augment
from tpufusion.data import pipeline as jax_pipeline
from tpufusion.geometry import boxes as jax_boxes
from tpufusion.geometry import encoding as jax_encoding
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion.models import io as jax_io
from tpufusion.models.fcn import FCN as JaxFCN
from tpufusion.models.losses import weighted_pose_loss as jax_loss
from tpufusion.models.metrics import batch_metrics as jax_metrics
from tpufusion.train import pr_curves as jax_pr_curves
from tpufusion.train import train_step as jax_train_step
from tpufusion.train.stats import population_weights as jax_population_weights
from tpufusion_torch import _golden
from tpufusion_torch.config import (
    LossConfig,
    ModelConfig,
    PipelineConfig,
    RangeViewSpec,
    TrainConfig,
)
from tpufusion_torch.data import augment, pipeline
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry import boxes, encoding
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN, SampleWiseBN, uniform_init_
from tpufusion_torch.models.losses import weighted_pose_loss
from tpufusion_torch.models.metrics import batch_metrics
from tpufusion_torch.train import pr_curves
from tpufusion_torch.train.checkpoint import CheckpointManager
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import (
    encode_batch,
    make_eval_step,
    make_forward,
    make_train_step,
)
from tpufusion_torch.train.trainer import MetricHistory, Trainer

SMALL = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
SPECS = {"full": RangeViewSpec(), "small": SMALL}
LABEL_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATS_ATOL = 1e-6
N_POSES = 400


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy; 0-d stays 0-d


def _poses(n=N_POSES, seed=0):
    """n seeded poses 3-40 m away: the first 60 on the 360-degree seam
    (azimuth within 0.05 rad of pi, where a box's corners project to both
    ends of the image), every third one nearly axis-aligned. (Negative
    slice indices cannot come out of project_2d; `_pyslice_mask` is held
    to numpy's wrap on its own below.)"""
    rng = np.random.default_rng(seed)
    dist, ang = rng.uniform(3, 40, n), rng.uniform(-np.pi, np.pi, n)
    ang[:60] = np.pi - rng.uniform(-0.05, 0.05, 60)
    center = np.stack([dist * np.cos(ang), dist * np.sin(ang), rng.uniform(-1.5, 0.5, n)], 1)
    size = np.array([4.2, 1.6, 1.5]) + rng.uniform(-0.5, 0.5, (n, 3))
    yaw = rng.uniform(-np.pi, np.pi, n)
    yaw[::3] = rng.uniform(-0.05, 0.05, len(yaw[::3]))
    yaw[:60] = rng.uniform(-0.03, 0.03, 60)  # the box orbits the origin by yaw: stay on the seam
    return center.astype(np.float32), size.astype(np.float32), yaw.astype(np.float32)


def _images(b, spec, seed=1):
    rng = np.random.default_rng(seed)
    shape = (b, spec.height, spec.width)
    img = np.zeros(shape + (3,), np.float32)
    img[..., 0] = rng.uniform(0, 40, shape) * (rng.random(shape) > 0.3)
    img[..., 1] = rng.uniform(-2, 2, shape)
    img[..., 2] = rng.uniform(0, 1, shape)
    return img


# -- box geometry ---------------------------------------------------------------

@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("name", ["inner_rect", "outer_rect", "circle_rect"])
def test_rects_are_identical_on_seeded_poses(name, spec_name):
    """400 poses, the seam and negative-column cases among them: every
    rect edge equal (ints cut from float atan2 / asin / sqrt)."""
    c, s, y = _poses()
    spec = SPECS[spec_name]
    jspec = to_jax_config(spec)
    want = jax.jit(jax.vmap(lambda a, b, d: getattr(jax_boxes, name)(a, b, d, jspec)))(c, s, y)
    got = getattr(boxes, name)(t(c), t(s), t(y), spec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # boxes across the seam are in the set: their corners land at both ends of the image
    cols = boxes.sorted_projected_corners(t(c), t(s), t(y), spec)[..., 0]
    span = (cols.amax(dim=-1) - cols.amin(dim=-1)).numpy()
    assert (span > spec.width // 2).sum() >= 10, "no seam-straddling pose in the set"


def test_box_corners_and_projection_match():
    c, s, y = _poses(64)
    want = np.asarray(jax_boxes.box_corners_3d(c, s, y))
    got = boxes.box_corners_3d(t(c), t(s), t(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    jspec = jax_config.RangeViewSpec()
    wcol, wrow = jax_boxes.project_2d(want[..., 0], want[..., 1], want[..., 2], jspec)
    gcol, grow = boxes.project_2d(t(want[..., 0]), t(want[..., 1]), t(want[..., 2]), RangeViewSpec())
    np.testing.assert_array_equal(gcol.numpy(), np.asarray(wcol))
    np.testing.assert_array_equal(grow.numpy(), np.asarray(wrow))
    zero = boxes.project_2d(torch.zeros(2), torch.zeros(2), torch.zeros(2), RangeViewSpec())
    jzero = jax_boxes.project_2d(np.zeros(2), np.zeros(2), np.zeros(2), jspec)
    np.testing.assert_array_equal(zero[1].numpy(), np.asarray(jzero[1]))  # the l2 = 0 guard
    sorted_j = jax.vmap(lambda a, b, d: jax_boxes.sorted_projected_corners(a, b, d, jspec))(c, s, y)
    sorted_p = boxes.sorted_projected_corners(t(c), t(s), t(y), RangeViewSpec())
    np.testing.assert_array_equal(sorted_p.numpy(), np.asarray(sorted_j))  # stable order on ties


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("method", ["outer_rect", "inner_rect", "circle"])
def test_footprint_masks_are_identical(method, spec_name):
    c, s, y = _poses()
    spec = SPECS[spec_name]
    jspec = to_jax_config(spec)
    want = np.asarray(jax.jit(jax.vmap(
        lambda a, b, d: jax_encoding.footprint_mask(a, b, d, jspec, method)))(c, s, y))
    got = encoding.footprint_mask(t(c), t(s), t(y), spec, method).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want.sum(axis=(1, 2)) > 0).sum() > 20
    one = encoding.footprint_mask(t(c[7]), t(s[7]), t(y[7]), spec, method).numpy()
    np.testing.assert_array_equal(one, want[7])  # no batch axis


@pytest.mark.parametrize("lo, hi", [(3, 9), (-4, -1), (-3, 5), (7, 3), (-30, 4), (2, 40), (-1, 0)])
def test_pyslice_mask_is_numpys_slice(lo, hi):
    """Negative indices wrap as in numpy's arr[lo:hi] assignment."""
    n = 12
    want = np.zeros(n, bool)
    want[lo:hi] = True
    idx = torch.arange(n, dtype=torch.int32)
    got = encoding._pyslice_mask(torch.tensor(lo), torch.tensor(hi), n, idx).numpy()
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jax_encoding._pyslice_mask(jnp.asarray(lo), jnp.asarray(hi), n, jnp.arange(n)))
    np.testing.assert_array_equal(got, jgot)


# -- pixel angles and the label codecs -----------------------------------------

@pytest.mark.parametrize("col_start, width", [(0, None), (20, 50), (-30, 64), (180, 21)])
def test_pixel_angles_and_rotations_take_a_column_window(col_start, width):
    jspec = to_jax_config(SMALL)
    for fn in ("pixel_angles", "pixel_rotations"):
        want = getattr(jax_encoding, fn)(jspec, col_start, width)
        got = getattr(encoding, fn)(SMALL, col_start, width, device="cpu")
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.shape == w.shape and g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


CODECS = {
    "corner": ("encode_label_batch", {}),
    "direct_local": ("encode_direct_label_batch", {"yaw_frame": "local"}),
    "direct_global": ("encode_direct_label_batch", {"yaw_frame": "global"}),
    "direct_both": ("encode_direct_label_batch", {"yaw_frame": "both"}),
    "direct_rect": ("encode_direct_label_batch", {"yaw_frame": "local", "footprint": "rect"}),
}


@pytest.mark.parametrize("codec", sorted(CODECS))
def test_label_codecs_match(codec):
    fn, kw = CODECS[codec]
    c, s, y = (a[:8] for a in _poses(64, seed=3))
    img = _images(8, SMALL)
    jspec = to_jax_config(SMALL)
    want = np.asarray(getattr(jax_encoding, fn)(
        jnp.asarray(c), jnp.asarray(s), jnp.asarray(y), jnp.asarray(img), jspec, **kw))
    got = getattr(encoding, fn)(t(c), t(s), t(y), t(img), SMALL, **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])  # the footprint
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    assert want[..., 1].sum() > 0 or codec.startswith("direct")


def test_encode_direct_label_on_a_real_surface_and_unknown_frame():
    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(2), 4, 2048)
    img = range_view_project_batch(t(pts), SMALL, t(valid))
    jspec = to_jax_config(SMALL)
    want = np.asarray(jax_encoding.encode_direct_label_batch(
        jnp.asarray(gt["center"]), jnp.asarray(gt["size"]), jnp.asarray(gt["yaw"]),
        jnp.asarray(img.numpy()), jspec))
    got = encoding.encode_direct_label_batch(
        t(gt["center"]), t(gt["size"]), t(gt["yaw"]), img, SMALL).numpy()
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    assert want[..., 1].sum() > 0, "no surface pixel in the scenes"
    mask = encoding.box_surface_mask(t(gt["center"]), t(gt["size"]), t(gt["yaw"]), img, SMALL)
    np.testing.assert_array_equal(mask.numpy(), want[..., 1])
    with pytest.raises(ValueError, match="yaw_frame"):
        encoding.encode_direct_label(t(gt["center"][0]), t(gt["size"][0]), t(gt["yaw"][0]),
                                     img[0], SMALL, yaw_frame="polar")


@pytest.mark.parametrize("col_start, width", [(0, 201), (20, 50)])
def test_decode_corners_inverts_the_encoder(col_start, width):
    rng = np.random.default_rng(4)
    img = _images(1, SMALL)[0, :, col_start:col_start + width]
    reg = rng.normal(size=(SMALL.height, width, 24)).astype(np.float32)
    want = np.asarray(jax_encoding.decode_corners(
        jnp.asarray(reg), jnp.asarray(img), to_jax_config(SMALL), col_start))
    got = encoding.decode_corners(t(reg), t(img), SMALL, col_start).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)
    if col_start == 0:  # decode(encode) gives the corners back on footprint pixels
        full = _images(1, SMALL)[0]
        checked = 0
        for c, s, y in zip(*_poses(64, seed=3)):
            label = encoding.encode_label(t(c), t(s), t(y), t(full), SMALL)
            fg = label[..., 1] > 0.5
            if fg.any():
                corners = encoding.decode_corners(label[..., 2:], t(full), SMALL)
                target = boxes.box_corners_3d(t(c), t(s), t(y))
                assert float((corners[fg] - target).abs().max()) < 1e-3
                checked += 1
        assert checked >= 10


# -- augmentation ----------------------------------------------------------------

def test_roll_is_jnp_roll_and_augment_batch_takes_jaxs_shifts():
    """Fed the reference's own shifts, augment_batch is bit-identical."""
    c, s, y = (a[:6] for a in _poses(64, seed=5))
    img = _images(6, SMALL)
    lab = np.random.default_rng(6).normal(size=(6, SMALL.height, SMALL.width, 26)).astype(np.float32)
    jspec = to_jax_config(SMALL)
    key = jax.random.PRNGKey(9)
    shifts = np.asarray(jax.vmap(lambda k, a, b, d: jax_augment.sample_roll(k, a, b, d, jspec))(
        jax.random.split(key, 6), c, s, y))
    wimg, wlab = jax_augment.augment_batch(key, jnp.asarray(img), jnp.asarray(lab), c, s, y, jspec)
    gimg, glab = augment.augment_batch(None, t(img), t(lab), t(c), t(s), t(y), SMALL, shifts=t(shifts))
    np.testing.assert_array_equal(gimg.numpy(), np.asarray(wimg))
    np.testing.assert_array_equal(glab.numpy(), np.asarray(wlab))
    for shift in (0, 1, -7, 200, 201, 450):
        one, _ = augment.roll_frame(t(img[0]), t(lab[0]), shift)
        np.testing.assert_array_equal(one.numpy(), np.roll(img[0], shift, axis=1))


def test_sample_roll_never_splits_the_object_and_is_uniform():
    c, s, y = (a[60:64] for a in _poses(64, seed=7))  # away from the seam
    w = SMALL.width
    ul_x, _, lr_x, _ = (v.numpy() for v in boxes.outer_rect(t(c), t(s), t(y), SMALL))
    gen = torch.Generator().manual_seed(0)
    n = 4000
    draws = torch.stack([augment.sample_roll(gen, t(c), t(s), t(y), SMALL) for _ in range(n)]).numpy()
    assert draws.dtype == np.int64 and draws.min() >= 0 and draws.max() < w
    for i in range(4):
        lo, hi = np.clip(w - lr_x[i], 0, w), np.clip(w - ul_x[i] + 1, 0, w)
        invalid = set(range(lo, max(hi, lo)))
        assert invalid and not (set(draws[:, i].tolist()) & invalid), "a shift splits the object"
        valid = sorted(set(range(w)) - invalid)
        counts = np.bincount(draws[:, i], minlength=w)[valid]
        assert (counts > 0).mean() > 0.99, "a valid shift is never drawn"
        expected = n / len(valid)
        assert abs(counts.mean() - expected) < 1e-9
        assert counts.std() < 2.0 * np.sqrt(expected)  # a multinomial's spread
    again = augment.sample_roll(torch.Generator().manual_seed(0), t(c), t(s), t(y), SMALL)
    np.testing.assert_array_equal(again.numpy(), draws[0])  # one seed, one draw


def test_transform_point_cloud_is_a_rigid_xy_motion():
    pts = np.random.default_rng(8).normal(size=(500, 4)).astype(np.float32) * 10
    gen = torch.Generator().manual_seed(3)
    out, (angle, tx, ty) = augment.transform_point_cloud(gen, t(pts), max_rotation=1.0, max_translation=2.0)
    assert abs(float(angle)) <= 1.0 and abs(float(tx)) <= 2.0 and abs(float(ty)) <= 2.0
    np.testing.assert_array_equal(out[:, 2:].numpy(), pts[:, 2:])
    back = out[:, :2].numpy() - [float(tx), float(ty)]
    np.testing.assert_allclose(np.linalg.norm(back, axis=1), np.linalg.norm(pts[:, :2], axis=1), atol=1e-4)
    c, s = np.cos(float(angle)), np.sin(float(angle))
    np.testing.assert_allclose(back[:, 0], pts[:, 0] * c - pts[:, 1] * s, atol=1e-4)
    same, _ = augment.transform_point_cloud(torch.Generator().manual_seed(3), t(pts), 1.0, 2.0)
    assert torch.equal(same, out)


# -- loss, metrics, statistics ------------------------------------------------------

def _loss_inputs(nreg=24, seed=0, b=3, p=96):
    rng = np.random.default_rng(seed)
    y_true = np.zeros((b, p, 2 + nreg), np.float32)
    fg = rng.random((b, p)) < 0.2
    fg[2] = False  # a frame without foreground: the area clamp
    y_true[..., 0], y_true[..., 1] = ~fg, fg
    y_true[..., 2:] = rng.normal(size=(b, p, nreg)) * 6 * fg[..., None]
    y_pred = np.concatenate(
        [np.clip(rng.random((b, p, 2)), 1e-7, 1), rng.normal(size=(b, p, nreg))], -1
    ).astype(np.float32)
    y_pred[0, :5, 2:] = y_true[0, :5, 2:]  # exactly-zero diffs: the gradient-safe norm
    return y_pred, y_true


_BASE = dict(obj_to_bkg_ratio=0.1, avg_obj_size=10.0, weight_bb=0.5)
LOSS_CONFIGS = {
    "default": LossConfig(),
    "balanced": LossConfig(**_BASE),
    "no_w1": LossConfig(**_BASE, use_w1=False),
    "no_w2": LossConfig(**_BASE, use_w2=False),
    "neither": LossConfig(**_BASE, use_w1=False, use_w2=False),
    "channel_weights": LossConfig(**_BASE, reg_channel_weights=(1.0,) * 20 + (8.0,) * 4),
    "norm_clip": LossConfig(**_BASE, reg_target_norm_clip=25.0),
    "reference_compat": LossConfig(**_BASE, reference_compat=True),
    "compat_clip_weights": LossConfig(**_BASE, reference_compat=True, reg_target_norm_clip=25.0,
                                      reg_channel_weights=(0.5,) * 24),
}


@pytest.mark.parametrize("use_regression", [True, False])
@pytest.mark.parametrize("name", sorted(LOSS_CONFIGS))
def test_loss_matches_for_every_branch(name, use_regression):
    cfg = LOSS_CONFIGS[name]
    y_pred, y_true = _loss_inputs()
    want, wgrad = jax.value_and_grad(
        lambda p: jax_loss(p, jnp.asarray(y_true), to_jax_config(cfg), use_regression))(jnp.asarray(y_pred))
    p = t(y_pred).requires_grad_()
    got = weighted_pose_loss(p, t(y_true), cfg, use_regression)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= LOSS_RTOL * abs(float(want))
    wgrad = np.asarray(wgrad)
    assert np.isfinite(p.grad.numpy()).all(), "a zero diff gave a NaN gradient"
    np.testing.assert_allclose(p.grad.numpy(), wgrad, rtol=0, atol=1e-5 * np.abs(wgrad).max())
    # 4-d inputs are flattened over H x W
    got4 = weighted_pose_loss(t(y_pred).reshape(3, 8, 12, -1), t(y_true).reshape(3, 8, 12, -1),
                              cfg, use_regression)
    assert float(got4) == pytest.approx(float(got.detach()), rel=1e-6)


def test_loss_rejects_wrong_channel_weights_and_an_all_zero_diff_is_finite():
    y_pred, y_true = _loss_inputs(nreg=8)
    with pytest.raises(ValueError, match="reg_channel_weights has 5 entries for 8"):
        weighted_pose_loss(t(y_pred), t(y_true), LossConfig(reg_channel_weights=(1.0,) * 5))
    p = t(y_pred)
    p[..., 2:] = t(y_true)[..., 2:]  # every diff zero
    p.requires_grad_()
    for cfg in (LossConfig(), LossConfig(reference_compat=True)):
        p.grad = None
        weighted_pose_loss(p, t(y_true), cfg).backward()
        assert torch.isfinite(p.grad).all() and float(p.grad[..., 2:].abs().max()) == 0.0


@pytest.mark.parametrize("use_regression", [True, False])
def test_batch_metrics_match(use_regression):
    y_pred, y_true = _loss_inputs()
    y_pred[..., 1] = np.where(y_true[..., 1] > 0, 0.9, y_pred[..., 1])  # some true positives
    want = jax_metrics(jnp.asarray(y_pred), jnp.asarray(y_true), use_regression)
    got = batch_metrics(t(y_pred), t(y_true), use_regression)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].ndim == 0
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k
    assert float(want["recall"]) > 0.9


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_population_weights_match(spec_name):
    c, s, y = (a[:48] for a in _poses(64, seed=9))
    spec = SPECS[spec_name]
    want = jax_population_weights(c, s, y, to_jax_config(spec))
    got = population_weights(c, s, y, spec, device="cpu")
    assert got == pytest.approx(want, rel=1e-9) and want["average_area"] > 0
    far = np.tile([[1e-3, 0.0, 50.0]], (2, 1)).astype(np.float32)  # nothing to paint
    empty = population_weights(far, s[:2] * 0, y[:2], spec, device="cpu")
    assert empty == jax_population_weights(far, s[:2] * 0, y[:2], to_jax_config(spec))


# -- the FCN in training mode and the train step ------------------------------------

def _scene_batch(b=4, seed=11, n_points=2048):
    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(seed), b, n_points)
    return {"points": pts, "valid": valid, **gt}


def _tensors(batch, **extra):
    return {k: t(v) for k, v in {**batch, **extra}.items()}


def _jax_labels(batch, images, jspec, head, yaw_frame):
    gt = (jnp.asarray(batch["center"]), jnp.asarray(batch["size"]), jnp.asarray(batch["yaw"]))
    if head == "direct":
        return jax_encoding.encode_direct_label_batch(*gt, images, jspec, yaw_frame=yaw_frame)
    return jax_encoding.encode_label_batch(*gt, images, jspec)


def _jax_step_readings(mcfg, arrays, batch, head, yaw_frame, loss_cfg, shifts=None):
    """The reference's loss, gradients and BatchNorm statistics of one
    step's forward and backward on `batch` (train=True)."""
    jspec = to_jax_config(SMALL)
    model = jax_model_from_arrays(mcfg, arrays)
    images = jax_project(jnp.asarray(batch["points"]), jspec, jnp.asarray(batch["valid"]))
    labels = _jax_labels(batch, images, jspec, head, yaw_frame)
    if shifts is not None:
        images, labels = jax.vmap(jax_augment.roll_frame)(images, labels, jnp.asarray(shifts))
    jcfg = to_jax_config(loss_cfg)

    @nnx.jit
    def run(m, images, labels):
        return nnx.value_and_grad(lambda m: jax_loss(m(images, train=True), labels, jcfg))(m)

    loss, grads = run(model, images, labels)
    flat = {f"{a}/{b}": np.asarray(g, np.float32)
            for a, leaves in nnx.to_pure_dict(grads).items() for b, g in leaves.items()}
    return float(loss), flat, np.asarray(model.norm.mean[...]), np.asarray(model.norm.var[...])


def _port_step_readings(mcfg, arrays, batch, head, yaw_frame, loss_cfg, augment_on=False, shifts=None):
    model = FCN(mcfg)
    models_io.load_arrays(model, arrays)
    step = make_train_step(SMALL, loss_cfg, TrainConfig(batch_size=4, augment=augment_on),
                           head=head, yaw_frame=yaw_frame, device="cpu")
    extra = {} if shifts is None else {"shifts": np.asarray(shifts, np.int64)}
    loss, metrics = step(model, Adam(model.parameters(), 1e-3), _tensors(batch, **extra))
    assert loss.ndim == 0 and not loss.requires_grad and metrics["loss"] is loss
    grads = {n.replace(".", "/"): p.grad.numpy() for n, p in model.named_parameters()}
    return float(loss), grads, model.norm.mean.numpy(), model.norm.var.numpy()


def _grad_rel(got, want):
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)) for k in want}


STEP_CASES = {
    "corner": (ModelConfig(reg_output_activation="linear"), "corner", "local"),
    "corner_relu": (ModelConfig(), "corner", "local"),
    "direct_local": (ModelConfig(head="direct", reg_output_activation="linear", width_multiplier=2),
                     "direct", "local"),
    "direct_global": (ModelConfig(head="direct", reg_output_activation="linear"), "direct", "global"),
    "direct_both": (ModelConfig(head="direct", reg_output_activation="linear", yaw_codec="dual"),
                    "direct", "both"),
}
STEP_LOSS = LossConfig(obj_to_bkg_ratio=0.004, avg_obj_size=230.0, weight_bb=1.0)


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_gradients_match(case):
    """One step's loss, every gradient tensor and the BatchNorm's running
    statistics, float32: both heads, the three yaw frames."""
    mcfg, head, yaw_frame = STEP_CASES[case]
    arrays = random_arrays(FCN(mcfg), seed=3)
    batch = _scene_batch()
    want_loss, want, wmean, wvar = _jax_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    got_loss, got, gmean, gvar = _port_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    rel = _grad_rel(got, want)
    assert sorted(got) == sorted(want) and max(rel.values()) <= GRAD_RTOL, rel
    assert np.abs(want["deconv6b/kernel"]).max() > 0
    np.testing.assert_allclose(gmean, wmean, rtol=0, atol=STATS_ATOL)
    np.testing.assert_allclose(gvar, wvar, rtol=1e-6, atol=STATS_ATOL)


def test_train_step_rolls_by_the_given_shifts():
    """The corner head with the roll augmentation, fed the reference's
    shifts: the same step as the reference's."""
    mcfg, head, yaw_frame = STEP_CASES["corner"]
    arrays = random_arrays(FCN(mcfg), seed=4)
    batch = _scene_batch(seed=12)
    jspec = to_jax_config(SMALL)
    shifts = np.asarray(jax.vmap(lambda k, a, b, d: jax_augment.sample_roll(k, a, b, d, jspec))(
        jax.random.split(jax.random.PRNGKey(1), 4), batch["center"], batch["size"], batch["yaw"]))
    assert (shifts != 0).any()
    want_loss, want, *_ = _jax_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS, shifts)
    got_loss, got, *_ = _port_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS, True, shifts)
    assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert max(_grad_rel(got, want).values()) <= GRAD_RTOL
    # drawn from a generator instead: another roll, another loss, the same under one seed
    drawn = [_port_step_with_generator(mcfg, arrays, batch, seed) for seed in (0, 0, 1)]
    assert drawn[0] == drawn[1] and drawn[0] != drawn[2]


def _port_step_with_generator(mcfg, arrays, batch, seed):
    model = FCN(mcfg)
    models_io.load_arrays(model, arrays)
    step = make_train_step(SMALL, STEP_LOSS, TrainConfig(batch_size=4, augment=True), device="cpu")
    loss, _ = step(model, Adam(model.parameters(), 1e-3), _tensors(batch),
                   torch.Generator().manual_seed(seed))
    return float(loss)


@pytest.mark.parametrize("case", ["corner", "direct_local"])
def test_train_step_gradients_match_in_bf16(case):
    """bf16 compute, float32 parameters and float32 gradients. Kernels and
    the BatchNorm within 2**-6 of the reference's bf16 step. A conv bias's
    gradient is a sum of bf16 values over every pixel: torch sums it in
    float32, XLA on the CPU keeps bf16 partial sums, so the reference's
    bf16 bias gradients lie further from its own float32 ones than the
    port's do (ROADMAP Queue 3); the port's are held to the nearer of the
    two at 2**-3 (they read 3.1e-2 and 2.4e-2 here; the reference's side of
    the comparison is computed on this CPU and moves with it)."""
    base, head, yaw_frame = STEP_CASES[case]
    mcfg = dataclasses.replace(base, dtype="bfloat16")
    arrays = random_arrays(FCN(mcfg), seed=3)
    batch = _scene_batch()
    want_loss, want, wmean, wvar = _jax_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    _, want32, *_ = _jax_step_readings(base, arrays, batch, head, yaw_frame, STEP_LOSS)
    got_loss, got, gmean, gvar = _port_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    assert all(g.dtype == np.float32 for g in got.values())
    assert abs(got_loss - want_loss) <= 2.0**-8 * abs(want_loss)
    rel, rel32, jax_gap = _grad_rel(got, want), _grad_rel(got, want32), _grad_rel(want, want32)
    conv_bias = [k for k in rel if k.endswith("/bias") and not k.startswith("norm/")]
    rest = {k: v for k, v in rel.items() if k not in conv_bias}
    assert max(rest.values()) <= 2.0**-6, rest
    nearer = {k: min(rel[k], rel32[k]) for k in conv_bias}
    assert max(nearer.values()) <= 2.0**-3, nearer
    # what Queue 3 records: the port's bias gradients are no further from the
    # reference's float32 ones than the reference's own bf16 ones are
    assert max(rel32[k] for k in conv_bias) <= max(jax_gap[k] for k in conv_bias) + 2.0**-4
    np.testing.assert_allclose(gmean, wmean, rtol=0, atol=STATS_ATOL)  # the norm runs in float32
    np.testing.assert_allclose(gvar, wvar, rtol=1e-6, atol=STATS_ATOL)


@pytest.mark.parametrize("case", ["corner", "direct_local"])
def test_train_step_gradients_match_in_float16(case):
    """float16 compute, float32 parameters and float32 gradients, no loss
    scaling (JAX has none). The loss within 2**-11 of the reference's
    (reads 5e-6 and 2e-7 relative); kernels and the BatchNorm within 2**-9
    of the reference's float16 step (read 6.9e-4 at most; a step computed
    in float32 lies 3.7e-2 from it). A conv bias's gradient is summed in
    float16 partial sums by XLA on the CPU, as in bf16: the port's are
    held to the nearer of the reference's float16 and float32 gradients at
    2**-5 (read 7.3e-3). Where the reference's gradient is exactly 0 (an
    underflow or an unused output) the port's is too, and nowhere else."""
    base, head, yaw_frame = STEP_CASES[case]
    mcfg = dataclasses.replace(base, dtype="float16")
    arrays = random_arrays(FCN(mcfg), seed=3)
    batch = _scene_batch()
    want_loss, want, wmean, wvar = _jax_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    _, want32, *_ = _jax_step_readings(base, arrays, batch, head, yaw_frame, STEP_LOSS)
    got_loss, got, gmean, gvar = _port_step_readings(mcfg, arrays, batch, head, yaw_frame, STEP_LOSS)
    assert all(g.dtype == np.float32 for g in got.values())
    assert abs(got_loss - want_loss) <= 2.0**-11 * abs(want_loss)
    rel, rel32 = _grad_rel(got, want), _grad_rel(got, want32)
    conv_bias = [k for k in rel if k.endswith("/bias") and not k.startswith("norm/")]
    rest = {k: v for k, v in rel.items() if k not in conv_bias}
    assert max(rest.values()) <= 2.0**-9, rest
    nearer = {k: min(rel[k], rel32[k]) for k in conv_bias}
    assert max(nearer.values()) <= 2.0**-5, nearer
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]) == 0, np.asarray(w) == 0, err_msg=k)
    np.testing.assert_allclose(gmean, wmean, rtol=0, atol=STATS_ATOL)  # the norm runs in float32
    np.testing.assert_allclose(gvar, wvar, rtol=1e-6, atol=STATS_ATOL)


def test_batchnorm_keeps_the_biased_variance_unlike_torchs():
    """flax moves the biased batch variance into the running one with
    momentum 0.99; torch.nn.BatchNorm2d would store the unbiased one."""
    x = np.random.default_rng(5).normal(3.0, 2.0, (2, 4, 6, 3)).astype(np.float32)
    model = FCN(ModelConfig(), seed=0)
    model.norm(t(x).permute(0, 3, 1, 2), train=True)
    flat = x.reshape(-1, 3).astype(np.float64)
    np.testing.assert_allclose(model.norm.mean.numpy(), 0.01 * flat.mean(0), atol=1e-6)
    np.testing.assert_allclose(model.norm.var.numpy(), 0.99 + 0.01 * flat.var(0), atol=1e-6)
    theirs = torch.nn.BatchNorm2d(3, momentum=0.01)
    theirs.train()(t(x).permute(0, 3, 1, 2))
    assert float((theirs.running_var - model.norm.var).abs().max()) > 1e-4
    before = model.norm.var.clone()
    model(torch.zeros(1, 8, 201, 3))  # inference never moves the statistics
    assert torch.equal(model.norm.var, before)


@pytest.mark.parametrize("train", [False, True])
def test_sample_wise_bn_matches(train):
    mcfg = ModelConfig(sample_wise_bn=True)
    hw = (8, 201)
    model = FCN(mcfg, image_hw=hw)
    assert isinstance(model.norm, SampleWiseBN)
    arrays = random_arrays(model, seed=6)
    models_io.load_arrays(model, arrays)
    jmodel = jax_model_from_arrays_hw(mcfg, arrays, hw)
    x = _images(3, SMALL)[:, :8]
    want = np.asarray(nnx.jit(lambda m, x: m(x, train=train))(jmodel, jnp.asarray(x)))
    got = model(t(x), train=train).detach().numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-4)
    np.testing.assert_allclose(model.norm.mean.numpy(), np.asarray(jmodel.norm.mean[...]), atol=STATS_ATOL)
    np.testing.assert_allclose(model.norm.var.numpy(), np.asarray(jmodel.norm.var[...]), rtol=1e-6, atol=STATS_ATOL)
    moved = not np.array_equal(model.norm.mean.numpy(), arrays["norm/mean"])
    assert moved == train


def jax_model_from_arrays_hw(mcfg, arrays, hw):
    from tests.torch_golden import jax_module_from_arrays

    jcfg = to_jax_config(mcfg)
    return jax_module_from_arrays(lambda: JaxFCN(jcfg, 3, hw, rngs=nnx.Rngs(0)), arrays)


def test_seeded_init_draws_the_references_distribution():
    a, b, c = FCN(ModelConfig(), seed=1), FCN(ModelConfig(), seed=1), FCN(ModelConfig(), seed=2)
    ka, kc = a.deconv4.kernel.detach(), c.deconv4.kernel.detach()
    assert torch.equal(ka, b.deconv4.kernel.detach()) and not torch.equal(ka, kc)
    assert float(ka.min()) >= -0.05 and float(ka.max()) <= 0.05
    assert abs(float(ka.mean())) < 2e-3 and abs(float(ka.std()) - 0.1 / 12**0.5) < 2e-3
    assert float(a.deconv4.bias.abs().max()) == 0.0 and float(a.norm.scale.min()) == 1.0
    blank = FCN(ModelConfig())
    uniform_init_(blank, 1)
    assert torch.equal(blank.deconv4.kernel.detach(), ka)


@pytest.mark.parametrize("case", ["corner", "direct_global"])
def test_eval_step_and_metrics_match(case):
    mcfg, head, yaw_frame = STEP_CASES[case]
    arrays = random_arrays(FCN(mcfg), seed=7)
    batch = _scene_batch(seed=13)
    jstep = jax_train_step.make_eval_step(
        to_jax_config(SMALL), to_jax_config(STEP_LOSS), head=head, yaw_frame=yaw_frame)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    wloss, wmetrics = jstep(jax_model_from_arrays(mcfg, arrays), jbatch)
    model = FCN(mcfg)
    models_io.load_arrays(model, arrays)
    before = model.norm.mean.clone()
    gloss, gmetrics = make_eval_step(SMALL, STEP_LOSS, head=head, yaw_frame=yaw_frame, device="cpu")(
        model, _tensors(batch))
    assert float(gloss) == pytest.approx(float(wloss), rel=LOSS_RTOL)
    assert sorted(gmetrics) == sorted(wmetrics)
    for k in wmetrics:
        assert float(gmetrics[k]) == pytest.approx(float(wmetrics[k]), rel=1e-4, abs=1e-6), k
    assert torch.equal(model.norm.mean, before)
    # precomputed images and labels are taken as they are
    images, labels = encode_batch(_tensors(batch), SMALL, head, yaw_frame)
    again, _ = make_eval_step(SMALL, STEP_LOSS, head=head, yaw_frame=yaw_frame, device="cpu")(
        model, {"images": images, "labels": labels})
    assert float(again) == float(gloss)
    fimages, fpreds = make_forward(SMALL, device="cpu")(model, batch["points"])  # numpy follows too
    assert fimages.shape == (4, 32, 201, 3) and fpreds.shape[:3] == (4, 32, 201)


def test_five_step_trajectory_losses_match():
    """Adam 3e-3 from the same weights on the same batches, the corner head
    rolled by the reference's own draws: the losses of 5 steps."""
    mcfg, head, yaw_frame = STEP_CASES["corner"]
    arrays = random_arrays(FCN(mcfg), seed=8)
    jspec, jloss = to_jax_config(SMALL), to_jax_config(STEP_LOSS)
    tcfg = TrainConfig(batch_size=4, augment=True)
    jstep = jax_train_step.make_train_step(jspec, jloss, to_jax_config(tcfg))
    jmodel = jax_model_from_arrays(mcfg, arrays)
    jopt = nnx.Optimizer(jmodel, optax.adam(3e-3), wrt=nnx.Param)
    model = FCN(mcfg)
    models_io.load_arrays(model, arrays)
    opt = Adam(model.parameters(), 3e-3)
    step = make_train_step(SMALL, STEP_LOSS, tcfg, device="cpu")
    key = jax.random.PRNGKey(0)
    want, got = [], []
    for i in range(5):
        batch = _scene_batch(seed=20 + i % 2)
        key, sub = jax.random.split(key)
        shifts = np.asarray(jax.vmap(lambda k, a, b, d: jax_augment.sample_roll(k, a, b, d, jspec))(
            jax.random.split(sub, 4), batch["center"], batch["size"], batch["yaw"]))
        wl, _ = jstep(jmodel, jopt, {k: jnp.asarray(v) for k, v in batch.items()}, sub)
        gl, _ = step(model, opt, _tensors(batch, shifts=shifts.astype(np.int64)))
        want.append(float(wl))
        got.append(float(gl))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert want[-1] != want[0]


def test_a_mesh_waits_for_the_data_parallel_slice():
    """Data parallelism over the batch and the spatial axis are ported
    (tests/test_torch_parallel.py, tests/test_torch_spatial.py): a data x
    spatial mesh of two ranks asks for its process group rather than
    refusing the axis, and what is not a mesh of the port is refused,
    never taken for one."""
    from tpufusion_torch.config import MeshConfig
    from tpufusion_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="a mesh of 2 ranks needs a process group"):
        make_mesh(MeshConfig(n_devices=2, n_spatial=2), device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        make_train_step(SMALL, LossConfig(), TrainConfig(), mesh=object())
    with pytest.raises(TypeError, match="batch_sharding"):
        pipeline.BatchPipeline({"x": np.zeros((4, 2))}, 2, sharding=object(), device="cpu")


# -- the train golden ------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_golden():
    return load_npz(GOLDEN_TRAIN), load_npz(GOLDEN_MULTI), _golden.train_golden_inputs()


@pytest.mark.parametrize("case", sorted(_golden.TRAIN_CASES))
def test_port_step_matches_the_train_golden(case, train_golden):
    """What chip_smoke.py phase 15 checks on the card, here on the CPU:
    the full-width step (4 x 32,768 points, the shipped asset's model)."""
    golden, gm, batch = train_golden
    assert str(batch["sha256"]) == str(golden["inputs_sha256"])
    shifts = golden.get(f"{case}/shifts")
    labels = _golden.port_case_labels(case, ASSET, gm, batch, "cpu", shifts)
    same, label_abs = _golden.label_readings(labels, golden, case)
    assert same and label_abs <= LABEL_ATOL
    got = _golden.port_train_case(case, ASSET, gm, batch, "cpu", shifts)
    readings = _golden.train_case_readings(got, golden, case)
    for k, limit in _golden.train_case_limits(case).items():
        assert readings[k] <= limit, (k, readings)
    assert readings["metrics_abs"] <= 1e-3


def test_golden_train_file_is_current(train_golden):
    """Recomputes the detector cases of the train golden with JAX (the
    fusion steps, 8 full-size camera frames backward, are left as they
    are) and fails when the file is stale."""
    from tests.make_torch_port_golden import golden_train_arrays

    golden, _, _ = train_golden
    fresh = golden_train_arrays(with_fusion=False, previous=golden)
    assert sorted(fresh) == sorted(golden)
    for k, v in fresh.items():
        want = golden[k]
        if k.endswith(("label_index", "shifts", "inputs_sha256")):
            np.testing.assert_array_equal(v, want, err_msg=k)
            continue
        # float32 sums may differ in the last bits between CPUs, and XLA's
        # bf16 rounding by a step: a stale file differs by far more
        rtol = 1e-5
        if k.startswith("direct_bf16/"):
            rtol = 2.0**-6
            if v.dtype == np.uint16:
                v, want = _golden.from_bf16_bits(v), _golden.from_bf16_bits(want)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(v - want).max()) <= rtol * scale + 1e-9, k
    assert os.path.getsize(GOLDEN_TRAIN) < 1 << 20


# -- trainer, checkpoints, pipeline --------------------------------------------------------

def _trainer_cfg(**train):
    return PipelineConfig(
        range_view=SMALL, train=TrainConfig(**{"batch_size": 4, "augment": False, **train}))


def _image_batch(n=4, seed=1):
    batch = _scene_batch(n, seed)
    images = range_view_project_batch(t(batch["points"]), SMALL, t(batch["valid"])).numpy()
    return {"images": images, "center": batch["center"], "size": batch["size"], "yaw": batch["yaw"]}


def test_grad_accumulation(tmp_path):
    """grad_accum_steps=2: parameters change only on every 2nd micro-batch."""
    trainer = Trainer(_trainer_cfg(grad_accum_steps=2), outdir=str(tmp_path / "run"), device="cpu")
    batch = _tensors(_image_batch())
    before = trainer.model.conv1.kernel.detach().clone()
    trainer.train_step(trainer.model, trainer.optimizer, batch, trainer.generator)
    assert torch.equal(trainer.model.conv1.kernel.detach(), before)  # accumulating
    trainer.train_step(trainer.model, trainer.optimizer, batch, trainer.generator)
    assert float((trainer.model.conv1.kernel.detach() - before).abs().max()) > 0


def test_cosine_lr_schedule(tmp_path):
    """lr_schedule='cosine' decays the applied update toward
    lr_final_fraction * lr by lr_decay_steps."""
    cfg = _trainer_cfg(lr_schedule="cosine", lr_decay_steps=6, lr_final_fraction=1e-3)
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"), device="cpu")
    batch = _tensors(_image_batch())
    deltas = []
    for _ in range(7):
        before = trainer.model.conv1.kernel.detach().clone()
        trainer.train_step(trainer.model, trainer.optimizer, batch, trainer.generator)
        deltas.append(float((trainer.model.conv1.kernel.detach() - before).abs().max()))
    assert deltas[-1] < deltas[0] * 0.01, deltas
    with pytest.raises(ValueError, match="lr_schedule"):
        Trainer(_trainer_cfg(lr_schedule="linear"), outdir=str(tmp_path / "run2"), device="cpu")


def test_divergence_recovery(tmp_path):
    """A non-finite loss restores the last checkpoint."""
    trainer = Trainer(_trainer_cfg(epochs=1), outdir=str(tmp_path / "run"), device="cpu")
    assert not trainer._recover_from_divergence()  # nothing to restore yet
    trainer.ckpt.save(0, trainer.model, trainer.optimizer)
    want = trainer.model.conv1.kernel.detach().clone()
    assert trainer._params_finite()
    with torch.no_grad():
        trainer.model.conv1.kernel.fill_(float("nan"))
    assert not trainer._params_finite()
    assert trainer._recover_from_divergence()
    assert torch.equal(trainer.model.conv1.kernel.detach(), want)


def test_checkpoint_roundtrip(tmp_path):
    model = FCN(ModelConfig(), seed=0)
    opt = Adam(model.parameters(), 1e-3)
    x = torch.ones(1, 32, 201, 3)
    model(x, train=True).sum().backward()
    opt.step()
    want = model(x).detach()
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    mgr.save(3, model, opt)
    model2 = FCN(ModelConfig(), seed=42)
    opt2 = Adam(model2.parameters(), 1e-3)
    assert mgr.restore(model2, opt2, device="cpu") == 3
    assert torch.equal(model2(x).detach(), want)
    assert opt2.count == 1
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(opt.state[a]["mu"], opt2.state[b]["mu"])
        assert torch.equal(opt.state[a]["nu"], opt2.state[b]["nu"])
    mgr.close()


def test_checkpoint_keep_latest_and_model_only_restore(tmp_path):
    model = FCN(ModelConfig(), seed=0)
    opt = Adam(model.parameters(), 1e-3)
    gen = torch.Generator().manual_seed(5)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        mgr.restore(model, device="cpu")
    assert mgr.latest_step() is None
    for step in (1, 2, 10):
        with torch.no_grad():
            model.conv1.bias.fill_(float(step))
        mgr.save(step, model, opt, gen)
    assert mgr.steps() == [2, 10] and mgr.latest_step() == 10
    assert not [n for n in os.listdir(mgr.directory) if n.endswith(".tmp")]
    other = FCN(ModelConfig(), seed=1)
    assert mgr.restore(other, device="cpu") == 10  # a model alone, from model + optimizer
    assert float(other.conv1.bias[0]) == 10.0
    assert mgr.restore(other, step=2, device="cpu") == 2 and float(other.conv1.bias[0]) == 2.0
    drawn = torch.rand(3, generator=gen)
    gen2 = torch.Generator().manual_seed(99)
    mgr.restore(other, generator=gen2, device="cpu")
    assert torch.equal(torch.rand(3, generator=gen2), drawn)


def test_fit_recovers_from_divergence(tmp_path):
    """fit() sees a non-finite loss within divergence_check_every steps,
    restores the last checkpoint and ends with finite weights, reading the
    metrics back in spans, never a step at a time."""
    cfg = _trainer_cfg(epochs=1, divergence_check_every=2)
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"), device="cpu")
    trainer.ckpt.save(0, trainer.model, trainer.optimizer, trainer.generator)
    good = trainer.model.conv1.kernel.detach().clone()
    with torch.no_grad():
        trainer.model.conv1.kernel.fill_(float("nan"))
    drains = []
    orig = trainer._drain

    def counting_drain(pending, sums, nb):
        drains.append(len(pending))
        return orig(pending, sums, nb)

    trainer._drain = counting_drain
    hist = trainer.fit(pipeline.BatchPipeline(_image_batch(16, seed=3), 4, seed=0, device="cpu"))
    now = trainer.model.conv1.kernel.detach()
    assert torch.isfinite(now).all()
    assert len(hist.batch["loss"]) > 0 and np.isfinite(hist.batch["loss"]).all()
    assert all(n <= 2 for n in drains) and len(drains) >= 2
    assert float((now - good).abs().max()) > 0
    assert trainer.ckpt.latest_step() == trainer.step  # the final, finite checkpoint


def test_fit_never_checkpoints_non_finite_weights(tmp_path):
    trainer = Trainer(_trainer_cfg(epochs=1), outdir=str(tmp_path / "run"), device="cpu")
    with torch.no_grad():
        trainer.model.conv1.kernel.fill_(float("nan"))
    hist = trainer.fit(pipeline.BatchPipeline(_image_batch(8, seed=3), 4, seed=0, device="cpu"))
    assert trainer.ckpt.latest_step() is None and hist.epoch["loss"] == []


def test_trainer_fit_resume_and_artifacts(tmp_path):
    """fit writes checkpoints, metrics.jsonl and pr_curve.csv; a fresh
    trainer resumes to the same step, weights, moments and generator, and
    takes the same next step as the uninterrupted one."""
    cfg = PipelineConfig(
        range_view=SMALL, model=ModelConfig(reg_output_activation="linear"),
        train=TrainConfig(batch_size=4, epochs=2, augment=True, learning_rate=3e-3,
                          divergence_check_every=3, keep_checkpoints=2))
    out = str(tmp_path / "run")
    data = _scene_batch(8, seed=14)
    trainer = Trainer(cfg, outdir=out, device="cpu")
    hist = trainer.fit(pipeline.BatchPipeline(data, 4, seed=0, device="cpu"),
                       pipeline.BatchPipeline(data, 4, shuffle=False, device="cpu"))
    assert trainer.step == 4 and trainer.ckpt.steps() == [2, 4]
    assert len(hist.batch["loss"]) == 4 and len(hist.epoch["val_loss"]) == 2
    assert np.isfinite(hist.epoch["val_recall"]).all()
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["epoch"] for r in rows] == [0, 1] and rows[1]["step"] == 4 and "val_loss" in rows[1]
    csv_path = os.path.join(out, "pr_curve.csv")
    got, want = pr_curves.load_pr_csv(csv_path), jax_pr_curves.load_pr_csv(csv_path)
    assert sorted(got) == sorted(want) and len(got["loss"]) == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    resumed = Trainer(cfg, outdir=out, device="cpu")
    assert resumed.resume() and resumed.step == 4 and resumed.optimizer.count == 4
    assert torch.equal(resumed.generator.get_state(), trainer.generator.get_state())
    probe = _tensors(_scene_batch(4, seed=15))
    la, _ = trainer.train_step(trainer.model, trainer.optimizer, probe, trainer.generator)
    lb, _ = resumed.train_step(resumed.model, resumed.optimizer, probe, resumed.generator)
    assert float(la) == float(lb)
    for a, b in zip(trainer.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    assert not Trainer(cfg, outdir=str(tmp_path / "empty"), device="cpu").resume()


def test_trainer_direct_head_plumbed(tmp_path):
    """ModelConfig.head='direct' through the Trainer: the step encodes the
    direct targets with DecodeConfig.direct_yaw_frame; an unknown head
    raises."""
    cfg = PipelineConfig(
        range_view=SMALL, model=ModelConfig(head="direct", reg_output_activation="linear"),
        train=TrainConfig(batch_size=4, augment=False))
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"), device="cpu")
    batch = _tensors(_scene_batch())
    loss, metrics = trainer.train_step(trainer.model, trainer.optimizer, batch, trainer.generator)
    assert np.isfinite(float(loss)) and set(metrics) == {"loss", "precision", "recall", "reg_mse"}
    eloss, _ = trainer.eval_step(trainer.model, batch)
    assert np.isfinite(float(eloss))
    with pytest.raises(ValueError, match="head"):
        Trainer(cfg.replace(model=ModelConfig(head="nope")), outdir=str(tmp_path / "run2"), device="cpu")


def test_metric_history_and_binned_pr_copy_match(tmp_path):
    hist = MetricHistory()
    rng = np.random.default_rng(0)
    for i in range(6):
        m = {"loss": rng.random(), "precision": rng.random(), "recall": rng.random()}
        hist.record_batch(m)
        hist.record_epoch(m, m if i % 2 else None)
    path = str(tmp_path / "pr.csv")
    hist.write_pr_csv(path)
    got = pr_curves.load_pr_csv(path)
    assert np.isnan(got["val_loss"][0]) and not np.isnan(got["val_loss"][1])
    for a, b in zip(pr_curves.binned_pr(got["precision"], got["recall"], 5),
                    jax_pr_curves.binned_pr(got["precision"], got["recall"], 5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n, batch, shuffle", [(10, 4, True), (3, 8, True), (8, 4, False), (9, 2, True)])
def test_epoch_indices_copy_matches(n, batch, shuffle):
    got = pipeline.epoch_indices(n, batch, np.random.default_rng(5), shuffle)
    want = jax_pipeline.epoch_indices(n, batch, np.random.default_rng(5), shuffle)
    np.testing.assert_array_equal(got, want)
    assert set(range(n)) <= set(got.ravel().tolist())


def test_pipeline_device_resident_matches_streaming():
    """Resident and streaming modes give the same batches for one seed, and
    the reference's pipeline gives them too."""
    rng = np.random.default_rng(3)
    ds = {"points": rng.normal(0, 1, (20, 64, 4)).astype(np.float32),
          "center": rng.normal(0, 1, (20, 3)).astype(np.float32)}
    a = pipeline.BatchPipeline(ds, 8, seed=4, device_resident=True, device="cpu")
    b = pipeline.BatchPipeline(ds, 8, seed=4, device_resident=False, device="cpu")
    c = pipeline.BatchPipeline(ds, 8, seed=4, device_budget_bytes=16, device="cpu")
    j = jax_pipeline.BatchPipeline(ds, 8, seed=4, device_resident=False)
    assert a._dev is not None and b._dev is None and c._dev is None
    assert a.batches_per_epoch == 3
    for _ in range(2):  # two epochs: the shuffles stay in step
        n = 0
        for ba, bb, bc, bj in zip(a.epoch(), b.epoch(), c.epoch(), j.epoch()):
            n += 1
            for k in ds:
                assert ba[k].device.type == "cpu"
                assert torch.equal(ba[k], bb[k]) and torch.equal(ba[k], bc[k])
                np.testing.assert_array_equal(ba[k].numpy(), np.asarray(bj[k]))
        assert n == 3
    d = pipeline.BatchPipeline(ds, 8, seed=4, drop_remainder=True, device="cpu")
    assert d.batches_per_epoch == 2 and len(list(d.epoch())) == 2
    assert next(iter(d))["points"].shape == (8, 64, 4)


# -- weights and optimizer state across the two packages -----------------------------------

def test_port_trained_model_serves_in_the_jax_package_and_back(tmp_path):
    """save_state_npz -> tpufusion.models.io.load_state_npz -> the same
    forward (1e-5), and the reverse; float16 storage casts back."""
    mcfg = ModelConfig(head="direct", reg_output_activation="linear")
    model = FCN(mcfg, seed=3)
    step = make_train_step(SMALL, STEP_LOSS, TrainConfig(batch_size=4, augment=False), head="direct",
                           device="cpu")
    opt = Adam(model.parameters(), 3e-3)
    for seed in (30, 31):
        step(model, opt, _tensors(_scene_batch(seed=seed)))  # trained: weights and stats moved
    path = str(tmp_path / "port.npz")
    models_io.save_state_npz(path, model)
    assert sorted(np.load(path).files) == sorted(models_io.state_arrays(model))
    jmodel = JaxFCN(to_jax_config(mcfg), 3, rngs=nnx.Rngs(0))
    jax_io.load_state_npz(path, jmodel)
    x = _images(2, SMALL)
    want = np.asarray(nnx.jit(lambda m, x: m(x, train=False))(jmodel, jnp.asarray(x)))
    got = model(t(x)).detach().numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=1e-5)

    back = str(tmp_path / "jax.npz")
    jax_io.save_state_npz(back, jmodel)
    again = FCN(mcfg)
    models_io.load_state_npz(back, again)
    for (ka, va), (kb, vb) in zip(model.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    half = str(tmp_path / "half.npz")
    models_io.save_state_npz(half, model, dtype=np.float16)
    assert all(v.dtype == np.float16 for v in load_npz(half).values())
    models_io.load_state_npz(half, again)
    assert again.conv1.kernel.dtype == torch.float32
    assert float((again.conv1.kernel - model.conv1.kernel).abs().max()) < 1e-3


def test_optimizer_state_crosses_as_arrays():
    """Adam's count and moments after 3 optax steps, carried over as numpy
    arrays keyed like the parameters: the 4th step on one gradient is the
    same update (1e-6), and the arrays come back out equal."""
    mcfg = ModelConfig(use_regression=False)
    arrays = random_arrays(FCN(mcfg), seed=9)
    jmodel = jax_model_from_arrays(mcfg, arrays)
    params = nnx.state(jmodel, nnx.Param)
    tx = optax.adam(3e-3)
    state = tx.init(params)
    rng = np.random.default_rng(1)
    make_grads = lambda: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
    for _ in range(3):
        updates, state = tx.update(make_grads(), state, params)
        params = optax.apply_updates(params, updates)
    flat = lambda tree: {"/".join(map(str, k)): np.asarray(v[...] if hasattr(v, "__getitem__") else v)  # noqa: E731
                         for k, v in nnx.to_flat_state(tree)}
    carried = {"count": np.asarray(state[0].count)}
    carried.update({f"mu/{k}": v for k, v in flat(state[0].mu).items()})
    carried.update({f"nu/{k}": v for k, v in flat(state[0].nu).items()})

    model = FCN(mcfg)
    models_io.load_arrays(model, {**arrays, **flat(params)})
    opt = Adam(model.parameters(), 3e-3)
    models_io.optimizer_from_arrays(opt, model, carried)
    assert opt.count == 3
    out = models_io.optimizer_arrays(opt, model)
    assert sorted(out) == sorted(carried)
    for k in carried:
        np.testing.assert_array_equal(out[k], carried[k])
    grads = make_grads()
    updates, state = tx.update(grads, state, params)
    params = optax.apply_updates(params, updates)
    gflat = flat(grads)
    for name, p in model.named_parameters():
        p.grad = t(gflat[name.replace(".", "/")])
    opt.step()
    for k, v in flat(params).items():
        got = dict(model.named_parameters())[k.replace("/", ".")].detach().numpy()
        np.testing.assert_allclose(got, v, rtol=0, atol=1e-6, err_msg=k)
