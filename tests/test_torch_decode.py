"""Golden tests: the port's direct-pose decode against JAX, given the same
JAX FCN output (so the decode is tested on its own): every center, yaw
frame and fit boundary, at k=1 and top-4.

Tolerances: `found`, the heat mask, the labels and the extents exactly;
poses within POSE_ATOL (1e-4, tests/torch_golden.py): weighted means and
the Gauss-Newton fit sum in another order in the two frameworks. Yaw is
compared as an angle where the fit's pi tie may add 2 pi (ROADMAP
Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_golden import (
    GOLDEN_MULTI,
    MIXED_ASSET,
    POSE_ATOL,
    asset_configs,
    jax_asset_model,
    jax_beam_scans,
    jax_forward,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.decode import decode as jd
from tpufusion.geometry.encoding import pixel_points
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion_torch import DecodeConfig, RangeViewSpec
from tpufusion_torch.decode import decode as td

SPEC = RangeViewSpec()
JSPEC = to_jax_config(SPEC)  # the JAX side gets its own config classes
_jax_decode = jax.jit(jd.decode_batch_direct, static_argnums=(2, 3, 4))
_jax_heat = jax.jit(jax.vmap(jd._heat_components, in_axes=(0, None)), static_argnums=1)


@pytest.fixture(scope="module")
def frames():
    """Four beam-scan frames: JAX images and the asset's JAX FCN output."""
    pts, valid = jax_beam_scans(0, 4)
    images = np.array(
        range_view_project_batch(jnp.asarray(pts), JSPEC, jnp.asarray(valid))
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
    want = _jax_decode(jnp.asarray(preds), jnp.asarray(images), JSPEC, to_jax_config(cfg), 1)
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
    wants = [np.asarray(x) for x in _jax_heat(jnp.asarray(preds[..., 1]), to_jax_config(cfg))]
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
            jnp.asarray(img[b, ..., 0]), jnp.asarray(img[b, ..., 1]), JSPEC,
            to_jax_config(cfg),
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


@pytest.fixture(scope="module")
def two_vehicle_frames():
    """A two-vehicle frame and an oriented-ellipse frame of the multi
    golden, with the shipped asset's and the mixed asset's JAX FCN
    outputs: {"asset": (images, preds), "mixed": (images, preds)}."""
    with np.load(GOLDEN_MULTI) as z:
        pts = np.concatenate([z["multi_points"][:1], z["ell_points"][:1]])
        valid = np.concatenate([z["multi_valid"][:1], z["ell_valid"][:1]])
    images = np.array(
        range_view_project_batch(jnp.asarray(pts), JSPEC, jnp.asarray(valid))
    )
    return {
        "asset": (images, jax_forward(jax_asset_model(), images)),
        "mixed": (images, jax_forward(jax_asset_model(MIXED_ASSET), images)),
    }


def _mixed(**change):
    return dataclasses.replace(asset_configs(MIXED_ASSET)[1], **change)


def _check(images, preds, cfg, k):
    want = _jax_decode(jnp.asarray(preds), jnp.asarray(images), JSPEC, to_jax_config(cfg), k)
    got = td.decode_batch_direct(
        torch.from_numpy(preds), torch.from_numpy(images), SPEC, cfg, k
    )
    assert got["poses"].shape == (len(preds), k, 7)
    np.testing.assert_array_equal(got["found"].numpy(), np.asarray(want["found"]))
    np.testing.assert_array_equal(got["areas"].numpy(), np.asarray(want["areas"]))
    diff = wrapped_pose_diff(got["poses"].numpy(), np.asarray(want["poses"]))
    assert diff.max() <= POSE_ATOL, diff.max()
    return got


# the remaining centers and the dual-codec gates, at k=1 on the four
# single-vehicle frames
OPTION_CFGS = {
    "surface": lambda: _asset(direct_center="surface"),
    "head": lambda: _asset(direct_center="head"),
    "silhouette": lambda: _asset(direct_center="silhouette"),
    "yaw_auto": lambda: _mixed(fit_boundary="circle"),
    "fit_auto": lambda: _mixed(direct_yaw_frame="global"),
}


@pytest.mark.parametrize("name", sorted(OPTION_CFGS))
def test_decode_options_match_jax(frames, name):
    images, preds = frames
    if name in ("yaw_auto", "fit_auto"):  # need the dual-codec head
        preds = jax_forward(jax_asset_model(MIXED_ASSET), images)
    got = _check(images, preds, OPTION_CFGS[name](), 1)
    assert got["found"].all()


# top-4 on two-vehicle frames: every center, yaw frame and boundary
TOP4_CFGS = {
    **{f"center_{c}": (lambda c=c: _asset(direct_center=c)) for c in td._CENTERS},
    "yaw_local": lambda: _asset(direct_yaw_frame="local"),
    "yaw_global": lambda: _asset(direct_yaw_frame="global"),
    "yaw_auto": lambda: _mixed(fit_boundary="ellipse"),
    "fit_circle": lambda: _asset(fit_boundary="circle"),
    "fit_ellipse": lambda: _asset(fit_boundary="ellipse", fit_surface_scale=0.9),
    "fit_box": lambda: _asset(fit_boundary="box", fit_surface_scale=1.0),
    "fit_auto": lambda: _mixed(),
}


@pytest.mark.parametrize("name", sorted(TOP4_CFGS))
def test_decode_multi_obstacle_matches_jax(two_vehicle_frames, name):
    images, preds = two_vehicle_frames["mixed" if "auto" in name else "asset"]
    got = _check(images, preds, TOP4_CFGS[name](), 4)
    assert got["found"][0, :2].all()  # both vehicles of the two-vehicle frame


@pytest.mark.parametrize("n_points", [0, 1, 4, 5, 6, 60])
def test_silhouette_quantiles_match_jax(frames, n_points):
    """The silhouette center's 3 %/97 % quantiles over the NaN-masked
    cluster: torch.nanquantile's linear interpolation gives
    jnp.nanquantile's values for any number of points, and fewer than 5
    gated points keep the seed. The cluster is the first n_points valid
    pixels (raster order) of the first frame's largest cluster."""
    images, preds = frames
    img = images[:1]
    heat = _jax_heat(jnp.asarray(preds[:1, ..., 1]), to_jax_config(_asset()))
    mask, labels = np.asarray(heat[0])[0], np.asarray(heat[1])[0]
    valid = (img[0, ..., 0] > 0) & (img[0, ..., 1] > SPEC.min_height)
    roots, counts = np.unique(labels[mask & valid], return_counts=True)
    members = mask & valid & (labels == roots[counts.argmax()])
    assert members.sum() >= 60
    cluster = np.zeros_like(members)
    cluster.flat[np.flatnonzero(members)[:n_points]] = True
    seed = np.asarray(pixel_points(jnp.asarray(img[0]), JSPEC))[members].mean(axis=0)
    # a ray 45 degrees off the heading weighs both box axes' quantiles
    yaw = np.float32(np.arctan2(seed[1], seed[0]) - np.pi / 4)
    lwh = np.array([4.2, 1.6, 1.5], np.float32)
    want = np.asarray(
        jd._silhouette_center(
            jnp.asarray(preds[0]), jnp.asarray(img[0]), jnp.asarray(cluster), JSPEC,
            to_jax_config(_asset()), jnp.asarray(yaw), jnp.asarray(lwh), jnp.asarray(seed),
        )
    )
    got = td._silhouette_center(
        torch.from_numpy(img), torch.from_numpy(cluster)[None, None], SPEC,
        torch.tensor([[yaw]]), torch.from_numpy(lwh)[None, None],
        torch.from_numpy(seed)[None, None],
    )[0, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=POSE_ATOL)
    assert np.array_equal(got, seed) == (n_points < 5)


def test_decode_auto_needs_a_dual_codec_head(frames):
    images, preds = frames
    with pytest.raises(ValueError, match="dual-codec"):
        td.decode_batch_direct(
            torch.from_numpy(preds), torch.from_numpy(images), SPEC,
            _asset(direct_yaw_frame="auto"), 1,
        )
