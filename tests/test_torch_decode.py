"""Golden tests: the port's direct-pose decode against JAX, given the same
JAX FCN output (so the decode is tested on its own).

Tolerances: `found`, the heat mask, the labels and the extents exactly;
poses within POSE_ATOL (1e-4, tests/torch_golden.py): weighted means and
the Gauss-Newton fit sum in another order in the two frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import (
    POSE_ATOL,
    asset_configs,
    jax_asset_model,
    jax_beam_scans,
    jax_forward,
)
from tpufusion.config import DecodeConfig, RangeViewSpec
from tpufusion.decode import decode as jd
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion_torch.decode import decode as td

SPEC = RangeViewSpec()
_jax_decode = jax.jit(jd.decode_batch_direct, static_argnums=(2, 3, 4))
_jax_heat = jax.jit(jax.vmap(jd._heat_components, in_axes=(0, None)), static_argnums=1)


@pytest.fixture(scope="module")
def frames():
    """Four beam-scan frames: JAX images and the asset's JAX FCN output."""
    pts, valid = jax_beam_scans(0, 4)
    images = np.array(
        range_view_project_batch(jnp.asarray(pts), SPEC, jnp.asarray(valid))
    )
    return images, jax_forward(jax_asset_model(), images)


def _asset(**change):
    return dataclasses.replace(asset_configs()[1], **change)


DECODE_CFGS = {
    "asset": lambda: _asset(),  # fit / circle / global yaw
    "defaults": DecodeConfig,  # backproject / local yaw
    "fit_ellipse": lambda: _asset(fit_boundary="ellipse", fit_surface_scale=0.9),
    "fit_box": lambda: _asset(fit_boundary="box", fit_surface_scale=1.0),
    "consensus": lambda: _asset(direct_center="consensus"),
    "geometric": lambda: _asset(direct_center="geometric"),
    "backproject_local": lambda: _asset(direct_center="backproject", direct_yaw_frame="local"),
}


@pytest.mark.parametrize("name", sorted(DECODE_CFGS))
def test_decode_matches_jax(frames, name):
    images, preds = frames
    cfg = DECODE_CFGS[name]()
    want = _jax_decode(jnp.asarray(preds), jnp.asarray(images), SPEC, cfg, 1)
    got = td.decode_batch_direct(
        torch.from_numpy(preds), torch.from_numpy(images), SPEC, cfg, 1
    )
    np.testing.assert_array_equal(got["found"].numpy(), np.asarray(want["found"]))
    np.testing.assert_array_equal(got["areas"].numpy(), np.asarray(want["areas"]))
    np.testing.assert_allclose(
        got["poses"].numpy(), np.asarray(want["poses"]), rtol=0, atol=POSE_ATOL
    )
    if name == "asset":
        assert got["found"].all()  # the asset detects on every frame


@pytest.mark.parametrize("name", ["asset", "defaults"])
def test_heat_components_match_jax(frames, name):
    images, preds = frames
    cfg = DECODE_CFGS[name]()
    got = [t.numpy() for t in td._heat_components(torch.from_numpy(preds[..., 1]), cfg)]
    wants = [np.asarray(x) for x in _jax_heat(jnp.asarray(preds[..., 1]), cfg)]
    for b in range(len(preds)):
        want = [w[b] for w in wants]
        mask = want[0]
        np.testing.assert_array_equal(got[0][b], mask)
        np.testing.assert_array_equal(got[1][b], want[1])  # labels
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g[b][mask], w[mask])
        assert mask.any()


def test_back_projection_fallback_matches_jax(frames):
    """A centroid on an empty pixel takes the nearest valid pixel in the
    bbox (first in raster order among exact-distance ties)."""
    images, _ = frames
    img = images.copy()
    img[:, 10:20, 100:140] = [0.0, SPEC.min_height, 0.0]  # no returns here
    centroid = np.array([[120, 15]] * len(img), np.int32)
    bbox = np.array([[95, 8, 145, 22]] * len(img), np.int32)
    cfg = DecodeConfig()
    got = td.back_project_2d_to_3d(
        torch.from_numpy(centroid).long(), torch.from_numpy(bbox).long(),
        torch.from_numpy(img[..., 0]), torch.from_numpy(img[..., 1]), SPEC, cfg,
    )
    for b in range(len(img)):
        xyz, c2, ok = jd.back_project_2d_to_3d(
            jnp.asarray(centroid[b]), jnp.asarray(bbox[b]),
            jnp.asarray(img[b, ..., 0]), jnp.asarray(img[b, ..., 1]), SPEC, cfg,
        )
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(c2))
        assert bool(got[2][b]) == bool(ok)
        np.testing.assert_allclose(got[0][b].numpy(), np.asarray(xyz), rtol=0, atol=POSE_ATOL)


def test_empty_frames_decode_to_nothing(frames):
    images, preds = frames
    blank = preds.copy()
    blank[..., 1] = 0.0
    got = td.decode_batch_direct(
        torch.from_numpy(blank), torch.from_numpy(images), SPEC, _asset(), 1
    )
    assert not got["found"].any()
    assert (got["poses"] == 0).all()


@pytest.mark.parametrize(
    "change",
    [
        {"direct_center": "surface"},
        {"direct_center": "head"},
        {"direct_center": "silhouette"},
        {"direct_yaw_frame": "auto"},
        {"fit_boundary": "auto"},
    ],
)
def test_decode_options_not_ported_raise(frames, change):
    images, preds = frames
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td.decode_batch_direct(
            torch.from_numpy(preds), torch.from_numpy(images), SPEC, _asset(**change), 1
        )


def test_decode_multi_obstacle_not_ported_raises(frames):
    images, preds = frames
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        td.decode_batch_direct(
            torch.from_numpy(preds), torch.from_numpy(images), SPEC, _asset(), 2
        )
