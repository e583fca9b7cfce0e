"""The port's numpy scene generators against the JAX package's, on the CPU.

The port draws from `numpy.random.Generator`, the reference from
`jax.random`: the bits cannot match, so the geometry is held on fixed
rays and the rest by distribution.

* Geometry: both ray-casters run with every random draw at its floor
  (`jax.random.normal` -> 0, `jax.random.uniform` -> minval; the port
  gets a generator that does the same): sweep phase 0, no ground or
  surface noise, no clutter, no dropout. On the same rays and vehicles,
  `valid` and the intensity class (vehicle or ground) must be equal and
  the points within 1e-4 m, for the circle, ellipse and box surfaces,
  yaws on and across +-pi, and rays parallel to a box's sides.
* Distributions: vehicle distance within 8-30 m, the reference's mean
  within 4 standard errors, slot spacing >= 2 pi / V - 0.6 rad (>= 0.7
  for V <= 4), per-axis speeds
  <= 2 m/s, the orbit convention of the oriented sequence, and each
  shape, dtype and timestamp as the reference gives them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpufusion.data import synthetic as jax_synth
from tpufusion_torch.data import synthetic

POINT_ATOL = 1e-4  # metres


class FloorDraws:
    """A generator whose every draw is its distribution's floor: uniform
    -> low, normal -> 0 (what the patched jax.random gives)."""

    def uniform(self, low=0.0, high=1.0, size=None):
        return np.full(size, low, np.float64)

    def standard_normal(self, size=None):
        return np.zeros(size)


@pytest.fixture
def jax_floor_draws(monkeypatch):
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.broadcast_to(jnp.asarray(minval, dtype), shape)

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.zeros(shape, dtype)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "normal", normal)


# (centers (B, V, 3), yaws (B, V)): vehicles 8-20 m away, yaws on and
# across +-pi; frame 0's first box lies along +x at yaw 0, so the ray at
# azimuth 0 (phase 0) runs parallel to its long sides, inside the slab.
CENTERS = np.array([
    [[10.0, 0.5, -0.7], [-12.0, 6.0, -0.7]],
    [[8.5, -9.0, -0.7], [-14.0, -3.0, -0.7]],
    [[0.4, 16.0, -0.7], [18.0, 7.5, -0.7]],
    [[-9.0, -11.0, -0.7], [11.0, -1.2, -0.7]],
], np.float32)
YAWS = np.array([
    [0.0, np.pi],
    [-np.pi, np.pi - 1e-3],
    [-np.pi + 1e-3, 3.5],
    [np.pi / 2, -2.0],
], np.float32)
SIZES = np.broadcast_to(np.array([4.2, 1.6, 1.5], np.float32), CENTERS.shape).copy()
SIZES[2, 1] = (5.5, 2.1, 1.9)


@pytest.mark.parametrize("surface", ["circle", "ellipse", "box"])
def test_raycast_surfaces_match_the_reference_on_fixed_rays(surface, jax_floor_draws):
    b, beams, azimuths = len(CENTERS), 32, 1024
    want_pts, want_valid = jax_synth._raycast_scene(
        jax.random.PRNGKey(0), b, beams, azimuths, jnp.asarray(CENTERS), jnp.asarray(SIZES),
        60.0, 0, 0.0, vehicle_surface=surface, yaws=jnp.asarray(YAWS))
    got_pts, got_valid = synthetic._raycast_scene(
        FloorDraws(), b, beams, azimuths, CENTERS, SIZES, 60.0, 0, 0.0,
        vehicle_surface=surface, yaws=YAWS)
    want_pts, want_valid = np.asarray(want_pts), np.asarray(want_valid)
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_pts[..., 3], want_pts[..., 3])  # vehicle 30, ground 3
    assert np.abs(got_pts[..., :3] - want_pts[..., :3]).max() <= POINT_ATOL
    vehicle_rays = (want_pts[..., 3] == 30.0).sum(axis=1)
    assert (vehicle_rays > 0).all(), vehicle_rays  # every frame's vehicles are hit
    if surface == "box":  # the ray along +x, parallel to the first box's sides
        along_x = np.arange(beams) * azimuths
        hits = want_valid[0, along_x] & (want_pts[0, along_x, 3] == 30.0)
        assert hits.any()
        np.testing.assert_allclose(
            np.hypot(*got_pts[0, along_x[hits], :2].T), 10.0 - 2.1, atol=POINT_ATOL)


def test_the_surfaces_differ_where_they_should(jax_floor_draws):
    """The circle, ellipse and box are three surfaces, not one: the same
    rays enter them at other distances; an unknown surface raises."""
    rho = {}
    for surface in ("circle", "ellipse", "box"):
        pts, valid = synthetic._raycast_scene(
            FloorDraws(), 4, 32, 1024, CENTERS, SIZES, 60.0, 0, 0.0,
            vehicle_surface=surface, yaws=YAWS)
        rho[surface] = np.where(pts[..., 3] == 30.0, np.hypot(pts[..., 0], pts[..., 1]), np.inf)
    for a, b in (("circle", "ellipse"), ("ellipse", "box"), ("circle", "box")):
        assert (rho[a] != rho[b]).mean() > 1e-3, (a, b)
    with pytest.raises(ValueError, match="vehicle_surface"):
        synthetic._raycast_scene(FloorDraws(), 1, 32, 64, CENTERS[:1], SIZES[:1], 60.0, 0, 0.0,
                                 vehicle_surface="cube")


def test_oriented_sequence_matches_the_reference_geometry(jax_floor_draws):
    """synthesize_beam_tracking_sequence(oriented=True) at floor draws:
    both generators lay out the same slots and velocities (-2 m/s on each
    axis, heading -3pi/4), so their ellipse sequences must agree ray for
    ray, and the gt is the orbit tuple of the same physical paths."""
    want_pts, want_gt, want_valid = jax_synth.synthesize_beam_tracking_sequence(
        jax.random.PRNGKey(0), 3, 8192, n_vehicles=2, n_clutter=0, dropout=0.0, oriented=True)
    got_pts, got_gt, got_valid = synthetic.synthesize_beam_tracking_sequence(
        FloorDraws(), 3, 8192, n_vehicles=2, n_clutter=0, dropout=0.0, oriented=True)
    np.testing.assert_array_equal(got_valid, np.asarray(want_valid))
    assert np.abs(got_pts - np.asarray(want_pts)).max() <= POINT_ATOL
    for k in ("center", "size", "yaw"):
        np.testing.assert_allclose(got_gt[k], np.asarray(want_gt[k]), atol=1e-5)
    assert (got_pts[..., 3] == 30.0).any()


# -- distributions ------------------------------------------------------------------------

def _mean_close(got, want):
    got, want = np.asarray(got, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    se = np.sqrt(got.var() / got.size + want.var() / want.size)
    assert abs(got.mean() - want.mean()) <= 4 * se + 1e-9, (got.mean(), want.mean(), se)


def test_points_batch_matches_the_reference_distribution():
    b = 1500
    got, ggt = synthetic.synthesize_points_batch(np.random.default_rng(0), b, 64, vary_size=True)
    want, wgt = jax_synth.synthesize_points_batch(jax.random.PRNGKey(0), b, 64, vary_size=True)
    want, wgt = np.asarray(want), {k: np.asarray(v) for k, v in wgt.items()}
    assert got.shape == want.shape == (b, 64, 4) and got.dtype == np.float32
    assert {k: v.shape for k, v in ggt.items()} == {k: v.shape for k, v in wgt.items()}
    dist = np.hypot(ggt["center"][:, 0], ggt["center"][:, 1])
    assert dist.min() >= 8.0 and dist.max() <= 30.0 and (ggt["center"][:, 2] == np.float32(-0.7)).all()
    _mean_close(dist, np.hypot(wgt["center"][:, 0], wgt["center"][:, 1]))
    assert np.abs(ggt["yaw"]).max() <= 0.6
    _mean_close(np.abs(ggt["yaw"]), np.abs(wgt["yaw"]))
    lo, hi = np.array([3.5, 1.4, 1.2]), np.array([5.5, 2.1, 1.9])
    assert (ggt["size"] >= lo - 1e-6).all() and (ggt["size"] <= hi + 1e-6).all()
    for j in range(3):
        _mean_close(ggt["size"][:, j], wgt["size"][:, j])
    # the cluster: the last N // 8 points, inside 0.95 of the box around Rz(yaw) @ center
    c, s = np.cos(ggt["yaw"]), np.sin(ggt["yaw"])
    spot = np.stack([c * ggt["center"][:, 0] - s * ggt["center"][:, 1],
                     s * ggt["center"][:, 0] + c * ggt["center"][:, 1], ggt["center"][:, 2]], -1)
    off = np.abs(got[:, -8:, :3] - spot[:, None]) / (ggt["size"][:, None] / 2)
    assert off.max() <= 0.95 + 1e-4
    _mean_close(got[:, :-8, 3], want[:, :-8, 3])  # clutter intensity
    _mean_close(np.hypot(got[:, :-8, 0], got[:, :-8, 1]), np.hypot(want[:, :-8, 0], want[:, :-8, 1]))
    fixed, fgt = synthetic.synthesize_points_batch(np.random.default_rng(1), 2, 64)
    assert (fgt["size"] == np.float32([4.2, 1.6, 1.5])).all()


def _slot_angles(center):
    ang = np.arctan2(center[..., 1], center[..., 0])
    d = np.abs((ang[:, :, None] - ang[:, None, :] + np.pi) % (2 * np.pi) - np.pi)
    v = center.shape[1]
    return d[:, ~np.eye(v, dtype=bool)]


@pytest.mark.parametrize("v", [2, 5])
def test_multi_vehicle_batch_keeps_its_slots(v):
    got, ggt = synthetic.synthesize_multi_vehicle_batch(np.random.default_rng(v), 400, 160, v)
    want, wgt = jax_synth.synthesize_multi_vehicle_batch(jax.random.PRNGKey(v), 400, 160, v)
    assert got.shape == np.asarray(want).shape and ggt["center"].shape == (400, v, 3)
    # slots 2 pi / v apart, each jittered by up to 0.3 rad: >= 0.7 rad for v <= 4
    bound = 2 * np.pi / v - 0.6
    spacing = _slot_angles(ggt["center"])
    assert spacing.min() >= bound - 1e-5 and _slot_angles(np.asarray(wgt["center"])).min() >= bound - 1e-5
    assert v > 4 or bound >= 0.7
    _mean_close(spacing, _slot_angles(np.asarray(wgt["center"])))
    dist = np.hypot(ggt["center"][..., 0], ggt["center"][..., 1])
    assert dist.min() >= 8.0 and dist.max() <= 30.0
    assert (ggt["yaw"] == 0).all()
    m = (160 // 8) // v  # each vehicle's cluster in the last slots
    clusters = got[:, -v * m:, :3].reshape(400, v, m, 3)
    assert (np.abs(clusters - ggt["center"][:, :, None]) <= np.float32([2.0, 0.76, 0.72]) + 1e-4).all()
    with pytest.raises(ValueError):
        synthetic.synthesize_multi_vehicle_batch(np.random.default_rng(0), 1, 64, 6)


def test_tracking_sequence_moves_at_constant_velocity():
    frames = 12
    got, ggt = synthetic.synthesize_tracking_sequence(np.random.default_rng(3), frames, 256)
    want, wgt = jax_synth.synthesize_tracking_sequence(jax.random.PRNGKey(3), frames, 256)
    assert got.shape == np.asarray(want).shape and ggt["center"].shape == (frames, 2, 3)
    for gt in (ggt, {k: np.asarray(v) for k, v in wgt.items()}):
        step = np.diff(gt["center"], axis=0)  # (F - 1, V, 3)
        np.testing.assert_allclose(step, step[:1].repeat(frames - 1, 0), atol=1e-5)
        assert np.abs(step[..., :2]).max() <= 2.0 * 0.1 + 1e-6 and (step[..., 2] == 0).all()
    # speeds over many layouts: uniform in +-2 m/s on each planar axis
    speeds = np.concatenate([
        np.diff(synthetic.synthesize_tracking_sequence(np.random.default_rng(s), 2, 64)[1]["center"],
                axis=0)[0, :, :2] / 0.1 for s in range(200)])
    assert np.abs(speeds).max() <= 2.0 + 1e-5 and speeds.std() > 0.9


def test_beam_scans_vary_size_and_surfaces():
    for surface in ("circle", "ellipse", "box"):
        pts, gt, valid = synthetic.synthesize_beam_scan_batch(
            np.random.default_rng(4), 6, 8192, vary_size=True, max_yaw=0.45,
            vehicle_surface=surface)
        assert pts.shape == (6, 8192, 4) and 0.4 < valid.mean() < 0.9
        assert (pts[~valid] == 0).all() and np.abs(gt["yaw"]).max() <= 0.45
        assert ((gt["size"] >= [3.5, 1.4, 1.2]) & (gt["size"] <= [5.5, 2.1, 1.9])).all()
        assert ((pts[..., 3] >= 30.0) & valid).any()  # vehicle returns


def test_oriented_sequence_heads_along_its_velocity():
    """The physical path Rz(yaw) @ center moves along (cos yaw, sin yaw),
    in both packages; the gt size and yaw are constant over frames."""
    for seq in (synthetic.synthesize_beam_tracking_sequence(np.random.default_rng(8), 5, 4096,
                                                            oriented=True),
                jax_synth.synthesize_beam_tracking_sequence(jax.random.PRNGKey(8), 5, 4096,
                                                            oriented=True)):
        gt = {k: np.asarray(v, np.float64) for k, v in seq[1].items()}
        yaw = gt["yaw"]
        c, s = np.cos(yaw), np.sin(yaw)
        phys = np.stack([c * gt["center"][..., 0] - s * gt["center"][..., 1],
                         s * gt["center"][..., 0] + c * gt["center"][..., 1]], -1)
        step = np.diff(phys, axis=0)  # (F - 1, V, 2)
        heading = np.stack([c[1:], s[1:]], -1)
        cross = step[..., 0] * heading[..., 1] - step[..., 1] * heading[..., 0]
        assert np.abs(cross).max() <= 1e-5 and ((step * heading).sum(-1) > 0).all()
        assert (yaw == yaw[:1]).all()


def test_dataset_and_fit_params_match_the_reference():
    got, want = synthetic.synthesize_dataset(3, 5, 256), jax_synth.synthesize_dataset(3, 5, 256)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    np.testing.assert_array_equal(got["timestamp"], want["timestamp"])
    for scenes in ("beam", "beam-ellipse", "beam-box", "mixed", "uniform", "ellipse", "box"):
        assert synthetic.surface_fit_params(scenes) == jax_synth.surface_fit_params(scenes)
