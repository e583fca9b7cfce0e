"""Golden tests: the port's single-frame entry points against JAX's on the
same numpy inputs: `range_view_project`, `connected_components`,
`decode_frame`, `decode_frame_multi` and `decode_frame_direct`.

Tolerances: the range view and the labels exactly (integer logic and
correctly rounded float32, as the batch versions); the decodes as the
decode goldens hold the batch decodes (tests/test_torch_multi.py,
tests/test_torch_decode.py): `found`, the 2D cluster, the areas and the
overflow flags exactly, poses, 3D centroids and corners within POSE_ATOL
(1e-4), yaw compared as an angle (the fit's pi tie, ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import synthetic_cloud
from tests.torch_golden import (
    GOLDEN_MULTI,
    POSE_ATOL,
    asset_configs,
    label_prepared,
    load_npz,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.decode import decode as jd
from tpufusion.geometry import range_view as jrv
from tpufusion.ops import components as jcomponents
from tpufusion_torch import DecodeConfig, RangeViewSpec
from tpufusion_torch.decode import decode as td
from tpufusion_torch.geometry import range_view as trv
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.ops import cc, components

SPEC = RangeViewSpec()
JSPEC = to_jax_config(SPEC)


def _cloud(seed: int, n: int):
    rng = np.random.default_rng(seed)
    pts = synthetic_cloud(rng, n=n, with_vehicle_at=(11.0, -2.0, -0.7))
    pts = np.concatenate([pts, pts[:300]])  # exact-key ties
    pts[7] = np.nan
    valid = rng.random(len(pts)) > 0.1
    return pts, valid


@pytest.mark.parametrize("res_h_deg", [1.8, 0.2])
@pytest.mark.parametrize("with_valid", [False, True])
def test_range_view_project_is_bit_equal_to_jax(res_h_deg, with_valid):
    spec = RangeViewSpec(res_h_deg=res_h_deg)
    pts, valid = _cloud(int(res_h_deg * 10), 6000)
    v = valid if with_valid else None
    got = trv.range_view_project(torch.from_numpy(pts), spec,
                                 None if v is None else torch.from_numpy(v)).numpy()
    # eager, as the reference's viewer calls it: under jax.jit XLA contracts
    # the payload's x*x + y*y into a fused multiply-add, and ~2 % of the
    # occupied pixels' distances move by an ulp against eager JAX (itself)
    want = np.asarray(jrv.range_view_project(
        jnp.asarray(pts), to_jax_config(spec), None if v is None else jnp.asarray(v), "exact"))
    assert got.shape == (spec.height, spec.width, 3)
    np.testing.assert_array_equal(got, want)
    batch = range_view_project_batch(torch.from_numpy(pts[None]), spec,
                                     None if v is None else torch.from_numpy(v[None]))
    np.testing.assert_array_equal(got, batch[0].numpy())


@pytest.mark.parametrize("method", ["packed", "scatter", "sort16"])
def test_range_view_project_refuses_the_tpu_only_methods(method):
    with pytest.raises(NotImplementedError, match="not ported"):
        trv.range_view_project(torch.zeros(4, 4), SPEC, method=method)


def _masks():
    rng = np.random.default_rng(5)
    out = {f"density {d}": rng.random((32, 181)) < d for d in (0.05, 0.4, 0.6)}
    tall = rng.random((48, 60)) < 0.5
    tall[:, 30] = True  # one column joins every row: a component 48 rows tall
    out["48 rows"] = tall
    serp = np.zeros((40, 41), bool)  # a serpentine: many sweeps to converge
    serp[::2] = True
    serp[1::4, -1] = True
    serp[3::4, 0] = True
    out["serpentine 40 rows"] = serp
    out["empty"] = np.zeros((8, 9), bool)
    return out


_jax_labels = jax.jit(jcomponents.connected_components, static_argnums=(1, 2))


@pytest.mark.parametrize("name", sorted(_masks()))
@pytest.mark.parametrize("max_iters", [128, 3])
def test_connected_components_matches_jax(name, max_iters):
    """Equal labels, masks of more than one row of the kernel's 32-row
    tiles included (the CPU runs the plain sweeps at any size); with
    max_iters 3 both stop at the same unconverged sweep."""
    mask = _masks()[name]
    got = components.connected_components(torch.from_numpy(mask), max_iters).numpy()
    want = np.asarray(_jax_labels(jnp.asarray(mask), max_iters, "xla"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, cc.connected_components(torch.from_numpy(mask), max_iters).numpy())


def test_connected_components_labels_are_the_batch_labels():
    """The labels-only call gives the labels of the bbox call."""
    mask = _masks()["density 0.4"]
    labels = components.connected_components(torch.from_numpy(mask)).numpy()
    batch = components.connected_components_with_bbox(torch.from_numpy(mask[None]))[0][0].numpy()
    np.testing.assert_array_equal(labels, batch)
    assert (labels[~mask] == -1).all()


def test_connected_components_checks_its_arguments():
    with pytest.raises(ValueError, match="unknown cc impl"):
        components.connected_components(torch.zeros(4, 4, dtype=torch.bool), impl="mosaic")
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        cc.connected_components(torch.zeros(1, 4, 4, dtype=torch.bool))


def _assert_decode_equal(got: dict, want: dict, exact, close, pose_keys):
    assert sorted(got) == sorted(want)
    for k in exact:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in close:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=POSE_ATOL,
                                   err_msg=k)
    for k in pose_keys:
        diff = wrapped_pose_diff(got[k].numpy(), np.asarray(want[k]))
        assert diff.max() <= POSE_ATOL, (k, diff.max())


@pytest.fixture(scope="module")
def corner_frames():
    """Label-encoded corner outputs of the multi golden's two-vehicle frames."""
    g = load_npz(GOLDEN_MULTI)
    images = range_view_project_batch(torch.from_numpy(g["multi_points"][:2]), SPEC,
                                      torch.from_numpy(g["multi_valid"][:2]))
    return g["corner_ypred"], images.numpy()


@pytest.mark.parametrize("frame", [0, 1])
def test_decode_frame_matches_jax(corner_frames, frame):
    ypred, images = corner_frames
    got = td.decode_frame(torch.from_numpy(ypred[frame]), torch.from_numpy(images[frame]), SPEC,
                          DecodeConfig())
    want = jax.jit(jd.decode_frame, static_argnums=(2, 3))(
        jnp.asarray(ypred[frame]), jnp.asarray(images[frame]), JSPEC, to_jax_config(DecodeConfig()))
    _assert_decode_equal(got, want, ("found", "centroid_2d", "bbox_2d", "area", "vote_overflow"),
                         ("centroid_3d", "corners_3d"), ("pose",))
    assert got["pose"].shape == (7,) and bool(got["found"])


@pytest.mark.parametrize("frame", [0, 1])
def test_decode_frame_multi_matches_jax(corner_frames, frame):
    ypred, images = corner_frames
    got = td.decode_frame_multi(torch.from_numpy(ypred[frame]), torch.from_numpy(images[frame]),
                                SPEC, DecodeConfig(), 4)
    want = jax.jit(jd.decode_frame_multi, static_argnums=(2, 3, 4))(
        jnp.asarray(ypred[frame]), jnp.asarray(images[frame]), JSPEC,
        to_jax_config(DecodeConfig()), 4)
    _assert_decode_equal(got, want, ("found", "areas", "vote_overflow"), (), ("poses",))
    assert got["poses"].shape == (4, 7) and bool(got["found"][0])


@pytest.fixture(scope="module")
def direct_frames():
    """Label-encoded direct-head outputs of two 32,768-point beam frames
    (the asset's yaw frame), with seeded noise."""
    preds, images, _ = label_prepared(3, 1, 2, SPEC, head="direct", n_points=32768)[0]
    return preds.numpy(), images.numpy()


@pytest.mark.parametrize("center,k", [(None, 1), ("consensus", 4), ("head", 1), ("silhouette", 2)])
@pytest.mark.parametrize("frame", [0, 1])
def test_decode_frame_direct_matches_jax(direct_frames, frame, center, k):
    preds, images = direct_frames
    cfg = asset_configs()[1]
    got = td.decode_frame_direct(torch.from_numpy(preds[frame]), torch.from_numpy(images[frame]),
                                 SPEC, cfg, k, center)
    want = jax.jit(jd.decode_frame_direct, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(preds[frame]), jnp.asarray(images[frame]), JSPEC, to_jax_config(cfg), k,
        center)
    _assert_decode_equal(got, want, ("found", "areas"), (), ("poses",))
    assert got["poses"].shape == (k, 7) and bool(got["found"][0])


def test_decode_frame_direct_is_the_batch_row(direct_frames):
    preds, images = direct_frames
    cfg = dataclasses.replace(asset_configs()[1], fit_boundary="ellipse")
    batch = td.decode_batch_direct(torch.from_numpy(preds), torch.from_numpy(images), SPEC, cfg, 2)
    for frame in range(2):
        one = td.decode_frame_direct(torch.from_numpy(preds[frame]),
                                     torch.from_numpy(images[frame]), SPEC, cfg, 2)
        for key in ("poses", "found", "areas"):
            assert torch.equal(one[key], batch[key][frame]), key
