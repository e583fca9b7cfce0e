"""The port's BEV rasterizer, its scatters and the camera paint table
against the JAX package on the same numpy inputs (made from a seed).

Tolerances: the scatters, the BEV's counts (read back from the density)
and its two max channels are exact; the density channel is within 1e-4 of
255 (log1p's ulps); the paint gather is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufusion.config as jax_config
from tpufusion.geometry import bev as jax_bev
from tpufusion.geometry import camera as jax_camera
from tpufusion.ops import scatter as jax_scatter
from tpufusion_torch.config import BevSpec
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry import bev as port_bev
from tpufusion_torch.geometry import camera as port_camera
from tpufusion_torch.ops import scatter as port_scatter
from tpufusion_torch.ops.parity_inputs import bev_edge_cloud

DENSITY_ATOL = 1e-4
CHANNELS = [(True, True), (True, False), (False, True), (False, False)]


def _scatter_inputs(seed, batch=3, n=5000, pixels=257):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, pixels, (batch, n)).astype(np.int32)
    vals = (rng.standard_normal((batch, n)) * 10).astype(np.float32)
    valid = rng.random((batch, n)) > 0.3
    valid[1] = False  # an empty frame
    ids[2, :100] = 7  # a crowded pixel
    return ids, vals, valid, pixels


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_count_matches_jax(seed):
    ids, _, valid, p = _scatter_inputs(seed)
    got = port_scatter.scatter_count(torch.from_numpy(ids), torch.from_numpy(valid), p)
    assert got.shape == (3, p) and got.dtype == torch.float32
    for b in range(len(ids)):
        want = np.asarray(jax_scatter.scatter_count(jnp.asarray(ids[b]), jnp.asarray(valid[b]), p))
        np.testing.assert_array_equal(got[b].numpy(), want)
        one = port_scatter.scatter_count(torch.from_numpy(ids[b]), torch.from_numpy(valid[b]), p)
        np.testing.assert_array_equal(one.numpy(), want)


@pytest.mark.parametrize("fill", [0.0, -5.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_max_matches_jax(seed, fill):
    ids, vals, valid, p = _scatter_inputs(seed)
    vals[0, 3] = np.inf  # a non-finite maximum reads as `fill`, as in JAX
    got = port_scatter.scatter_max(
        torch.from_numpy(ids), torch.from_numpy(vals), torch.from_numpy(valid), p, fill
    )
    for b in range(len(ids)):
        want = np.asarray(jax_scatter.scatter_max(
            jnp.asarray(ids[b]), jnp.asarray(vals[b]), jnp.asarray(valid[b]), p, fill
        ))
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert (got[1] == fill).all()


def _assert_bev_equal(got: np.ndarray, want: np.ndarray, spec: BevSpec):
    assert got.shape == want.shape and got.dtype == np.float32
    # the density is a monotone function of the count: invert it exactly
    # enough to compare counts below the saturation at 63
    def counts(d):
        return np.rint(np.expm1(d.astype(np.float64) / 255.0 * np.log(spec.density_log_base)))
    np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0)
    np.testing.assert_array_equal(counts(got[..., 0]), counts(want[..., 0]))
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=DENSITY_ATOL)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])


@pytest.mark.parametrize("height,intensity", CHANNELS)
def test_bev_rasterize_batch_matches_jax(height, intensity):
    spec = BevSpec(with_height_channel=height, with_intensity_channel=intensity)
    jspec = jax_config.BevSpec(with_height_channel=height, with_intensity_channel=intensity)
    assert (spec.nx, spec.ny) == (1199, 180)
    scans, _, svalid = synthesize_beam_scan_batch(np.random.default_rng(2), 2, 4096)
    scans[:, :, :2] *= 3.0  # spread over the +-120 m grid and past it
    edge, evalid = bev_edge_cloud(spec)
    pts = np.concatenate([scans, edge[None]])
    valid = np.concatenate([svalid, evalid[None]])
    want = np.asarray(jax_bev.bev_rasterize_batch(jnp.asarray(pts), jspec, jnp.asarray(valid)))
    got = port_bev.bev_rasterize_batch(torch.from_numpy(pts), spec, torch.from_numpy(valid))
    assert got.shape == (3, 1199, 180, 1 + height + intensity)
    _assert_bev_equal(got.numpy(), want, spec)
    assert (want[..., 0] > 0).sum() > 2000
    # without a mask, and one frame through bev_rasterize
    want = np.asarray(jax_bev.bev_rasterize_batch(jnp.asarray(pts), jspec))
    got = port_bev.bev_rasterize_batch(torch.from_numpy(pts), spec)
    _assert_bev_equal(got.numpy(), want, spec)
    one = port_bev.bev_rasterize(torch.from_numpy(pts[2]), spec)
    np.testing.assert_array_equal(one.numpy(), got[2].numpy())


def test_bev_rasterize_xyz_only_points_and_other_grids():
    """(N, 3) points (no intensity column) and a coarser grid."""
    spec = BevSpec(max_range=40.0, res_x=0.5, res_y=0.7)
    jspec = jax_config.BevSpec(max_range=40.0, res_x=0.5, res_y=0.7)
    assert (spec.nx, spec.ny) == (jspec.nx, jspec.ny)
    pts, valid = bev_edge_cloud(spec, seed=9)
    want = np.asarray(jax_bev.bev_rasterize(jnp.asarray(pts[:, :3]), jspec, jnp.asarray(valid)))
    got = port_bev.bev_rasterize(torch.from_numpy(pts[:, :3]), spec, torch.from_numpy(valid))
    _assert_bev_equal(got.numpy(), want, spec)
    assert (got[..., 2] == 0).all()


def _cameras():
    out = []
    for mod in (port_camera, jax_camera):
        out.append(mod.synthetic_camera(1368, 512, 1400.0))
    return out


def test_paint_bev_matches_rgb_onto_bev():
    """paint_table + paint_bev (a gather on tensors) against the numpy
    painter, frame by frame: exact."""
    port_cam, jax_cam = _cameras()
    spec = BevSpec(with_height_channel=True, with_intensity_channel=False)
    table = port_camera.paint_table(port_cam, spec, "cpu")
    assert all(t.shape == (spec.nx, spec.ny) for t in table)
    assert 1000 < int(table[2].sum()) < spec.nx * spec.ny  # the camera sees a wedge
    rng = np.random.default_rng(4)
    imgs = rng.uniform(0, 1, (2, 512, 1368, 1)).astype(np.float32)
    got = port_camera.paint_bev(torch.from_numpy(imgs), table).numpy()
    for b in range(2):
        want = jax_camera.rgb_onto_bev(imgs[b], jax_cam, spec.nx, spec.ny)[..., 0]
        np.testing.assert_array_equal(got[b], want)
    assert (got != 0).sum() > 1000
