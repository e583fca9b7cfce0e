"""The port's host tools against the JAX package's on the same numpy
inputs: the renders of `tools/visualize.py` with and without their
overlays, the crops, the calibration, the GT analyzer, the dataset diff and
the invariant mask.

Tolerance: none. The renders are uint8 arrays computed by the same numpy
(and, for an overlay, the same cv2 calls at corners that the port's
`geometry/boxes.py` computes bit for bit as JAX's), the crops the same
bytes, the rest the same numpy / scipy code on the same inputs.
"""

import numpy as np
import pytest
import torch

from tests.conftest import synthetic_cloud
from tests.torch_golden import to_jax_config
from tpufusion.tools import analyze as jax_analyze
from tpufusion.tools import calibrate as jax_calibrate
from tpufusion.tools import crops as jax_crops
from tpufusion.tools import datadiff as jax_datadiff
from tpufusion.tools import invariant_mask as jax_invariant
from tpufusion.tools import visualize as jax_viz
from tpufusion_torch.config import BevSpec, RangeViewSpec
from tpufusion_torch.geometry import camera as port_camera
from tpufusion_torch.geometry.bev import bev_rasterize
from tpufusion_torch.geometry.range_view import range_view_project
from tpufusion_torch.tools import analyze, calibrate, crops, datadiff, invariant_mask
from tpufusion_torch.tools import visualize as viz

SPEC = RangeViewSpec(res_h_deg=1.8)
POSES = {  # center, size, yaw: ahead, behind on the seam, close and turned
    "ahead": ((12.0, -3.0, -0.7), (4.2, 1.6, 1.5), 0.0),
    "seam": ((-15.0, 0.4, -0.5), (4.5, 1.8, 1.6), 2.9),
    "close": ((5.5, 4.0, -0.9), (4.0, 1.7, 1.4), -1.1),
}


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(2)
    cloud = synthetic_cloud(rng, n=3000, with_vehicle_at=(12.0, -3.0, -0.7))
    pts = torch.from_numpy(cloud)
    image = range_view_project(pts, SPEC).numpy()
    bev = bev_rasterize(pts, BevSpec()).numpy()
    return image, bev


def test_gray_to_bgr_is_cv2s():
    import cv2

    gray = np.random.default_rng(0).integers(0, 256, (17, 33), dtype=np.uint8)
    np.testing.assert_array_equal(viz.gray_to_bgr(gray), cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))


@pytest.mark.parametrize("pose", [None] + sorted(POSES))
def test_render_range_view_matches_jax(scene, pose):
    image, _ = scene
    kw = {} if pose is None else dict(zip(("center", "size", "yaw"), POSES[pose]))
    got = viz.render_range_view(image, spec=SPEC, **kw)
    want = jax_viz.render_range_view(image, spec=to_jax_config(SPEC), **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if pose is not None:  # the overlay drew something
        assert (got != viz.render_range_view(image, spec=SPEC)).any()


@pytest.mark.parametrize("pose", [None] + sorted(POSES))
def test_render_bev_matches_jax(scene, pose):
    _, bev = scene
    kw = {} if pose is None else dict(zip(("center", "size", "yaw"), POSES[pose]))
    got = viz.render_bev(bev, spec=BevSpec(), **kw)
    want = jax_viz.render_bev(bev, spec=to_jax_config(BevSpec()), **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bbox", [None, (10, 5, 60, 20), (0, 0, 0, 0)])
def test_render_class_mask_matches_jax(scene, bbox):
    image, _ = scene
    prob = np.random.default_rng(3).uniform(0, 1, image.shape[:2]).astype(np.float32)
    np.testing.assert_array_equal(viz.render_class_mask(prob, bbox), jax_viz.render_class_mask(prob, bbox))


def test_render_constant_image_is_black():
    flat = np.full((4, 6, 3), 7.0, np.float32)
    np.testing.assert_array_equal(viz.render_range_view(flat, spec=SPEC), np.zeros((4, 6, 3), np.uint8))


def test_save_writes_the_references_file(scene, tmp_path):
    image, _ = scene
    canvas = viz.render_range_view(image, spec=SPEC)
    viz.save(str(tmp_path / "port.png"), canvas)
    jax_viz.save(str(tmp_path / "jax.png"), canvas)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_radar_boxes_and_edges_match_jax():
    from tpufusion.geometry import camera as jax_camera

    rng = np.random.default_rng(4)
    frame = rng.integers(0, 80, (512, 1368, 3), dtype=np.uint8)
    tracks = [{"timestamp": 5, "range": 15.0, "angle": 0.0}, {"range": 25.0, "angle": -2.0, "rate": 1.0},
              {"range": 9.0, "angle": 6.5, "status": 3.0}]
    got = viz.render_radar_boxes_on_camera(frame, tracks, port_camera.synthetic_camera(), crop_top=256)
    want = jax_viz.render_radar_boxes_on_camera(frame, tracks, jax_camera.synthetic_camera(), crop_top=256)
    np.testing.assert_array_equal(got, want)
    assert (got != frame).any()
    gray = frame[..., 0].copy()
    gray[100:300, 400:900] = 255
    np.testing.assert_array_equal(viz.detect_edges(gray, 50, 150), jax_viz.detect_edges(gray, 50, 150))


def _poses(n=6, seed=5):
    rng = np.random.default_rng(seed)
    poses = np.column_stack([rng.uniform(6, 30, n), rng.uniform(-6, 6, n), rng.uniform(-1, 0, n),
                             rng.uniform(-1, 1, n), np.full(n, 4.2), np.full(n, 1.6), np.full(n, 1.5)])
    poses[2, :3] = 0.0  # no detection
    poses[3, 0] = -8.0  # behind the camera
    return poses


def test_crop_box_and_box_from_pose_match_jax():
    from tpufusion.geometry import camera as jax_camera

    image = np.zeros((512, 1368), np.uint8)
    for pose in _poses():
        got = crops.box_from_pose(pose, port_camera.synthetic_camera(), 256)
        want = jax_crops.box_from_pose(pose, jax_camera.synthetic_camera(), 256)
        assert got == want
        if want is not None:
            np.testing.assert_array_equal(crops.crop_box(image, got), jax_crops.crop_box(image, want))
    for box in ((-3.2, 10.4, 40.6, 90.5), (30.0, 30.0, 29.0, 80.0), (500.0, 1300.0, 900.0, 2000.0)):
        g, w = crops.crop_box(image, box), jax_crops.crop_box(image, box)
        assert (g is None) == (w is None)
        if w is not None:
            assert g.shape == w.shape


def test_extract_crops_writes_the_references_jpegs(tmp_path):
    from tpufusion.geometry import camera as jax_camera

    rng = np.random.default_rng(6)
    images = rng.integers(0, 255, (6, 512, 1368), dtype=np.uint8)
    poses = _poses()
    got = crops.extract_crops(images, poses, port_camera.synthetic_camera(), str(tmp_path / "port"),
                              tag="t 1", crop_top=256)
    want = jax_crops.extract_crops(images, poses, jax_camera.synthetic_camera(), str(tmp_path / "jax"),
                                   tag="t 1", crop_top=256)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want]
    assert len(got) >= 3
    for g, w in zip(got, want):
        assert open(g, "rb").read() == open(w, "rb").read()


def _correspondences(seed=0, n=12):
    """A synthetic camera with a known lidar->camera transform and the
    pixels of seeded lidar points under it."""
    true = np.array([0.2, -0.1, 0.3, 0.4, -0.2, 0.1])
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    cam = port_camera.synthetic_camera(640, 480, 500.0)
    cam.set_extrinsic_from_euler(true[:3], true[3:])
    return pts, cam.project_lidar_to_pixels(pts)


@pytest.mark.parametrize("accept_px", [0.5, 1e-9])
def test_calibrate_matches_jax(accept_px):
    """The same dict at the same seed: accepted, and (accept 1e-9) all
    restarts run without acceptance."""
    from tpufusion.geometry import camera as jax_camera

    pts, uvs = _correspondences()
    kw = dict(bounds=[(-1, 1)] * 6, accept_px=accept_px, max_restarts=3, seed=1)
    got = calibrate.calibrate(port_camera.synthetic_camera(640, 480, 500.0), pts, uvs, **kw)
    want = jax_calibrate.calibrate(jax_camera.synthetic_camera(640, 480, 500.0), pts, uvs, **kw)
    assert got == want
    x = np.asarray(want["rotations"] + want["translation"])
    assert calibrate.reprojection_error(x, port_camera.synthetic_camera(640, 480, 500.0), pts, uvs) == \
        jax_calibrate.reprojection_error(x, jax_camera.synthetic_camera(640, 480, 500.0), pts, uvs)


def test_calibrate_from_settings_matches_jax(tmp_path):
    """The settings json (with // comments, the reference's parameter
    order) and a camera yaml, through both packages."""
    import json

    import yaml

    pts, uvs = _correspondences(3, 8)
    cam = port_camera.synthetic_camera(640, 480, 500.0)
    (tmp_path / "cam.yaml").write_text(yaml.dump({
        "image_width": 640, "image_height": 480,
        "camera_matrix": {"data": cam.K.ravel().tolist()},
        "distortion_coefficients": {"data": [0.0] * 5},
        "rectification_matrix": {"data": np.eye(3).ravel().tolist()},
        "projection_matrix": {"data": cam.P.ravel().tolist()},
    }))
    settings = {"points": np.column_stack([pts, np.ones(len(pts))]).tolist(), "uvs": uvs.tolist(),
                "bounds": [[-1, 1]] * 6}
    (tmp_path / "s.json").write_text("// hand-labelled\n" + json.dumps(settings))
    args = (str(tmp_path / "s.json"), str(tmp_path / "cam.yaml"))
    got = calibrate.calibrate_from_settings(*args, max_restarts=4, seed=2)
    want = jax_calibrate.calibrate_from_settings(*args, max_restarts=4, seed=2)
    assert got == want


@pytest.mark.parametrize("kw", [{}, {"n_azimuth": 8, "n_range": 5, "max_range": 30.0}])
def test_polar_histogram_matches_jax(kw):
    centers = np.random.default_rng(7).uniform(-50, 50, (200, 2))
    for g, w in zip(analyze.polar_histogram(centers, **kw), jax_analyze.polar_histogram(centers, **kw)):
        np.testing.assert_array_equal(g, w)


def test_save_polar_plot_matches_jax(tmp_path):
    centers = np.random.default_rng(8).uniform(-50, 50, (50, 2))
    analyze.save_polar_plot(centers, str(tmp_path / "port.png"))
    jax_analyze.save_polar_plot(centers, str(tmp_path / "jax.png"))
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def _timestamps(seed, n, step=100_000_000):
    rng = np.random.default_rng(seed)
    return (np.arange(n) * step + rng.integers(-2_000_000, 2_000_000, n)).tolist()


def test_stream_summary_and_compare_match_jax():
    a = {"lidar": datadiff.stream_summary(_timestamps(0, 20)), "camera": datadiff.stream_summary([5])}
    b = {"lidar": datadiff.stream_summary(_timestamps(1, 12, 170_000_000))}
    ja = {"lidar": jax_datadiff.stream_summary(_timestamps(0, 20)), "camera": jax_datadiff.stream_summary([5])}
    jb = {"lidar": jax_datadiff.stream_summary(_timestamps(1, 12, 170_000_000))}
    assert a == ja and b == jb
    for x, y in ((a, b), (b, a), (a, a)):
        assert datadiff.compare_summaries(x, y) == jax_datadiff.compare_summaries(x, y)
    assert datadiff.compare_summaries(a, b)


def test_diff_dirs_matches_jax(tmp_path):
    for name, seed, n in (("a", 0, 20), ("b", 0, 19), ("c", 2, 20)):
        d = tmp_path / name
        d.mkdir()
        (d / "lidar_timestamps.csv").write_text(
            "timestamp\n" + "\n".join(map(str, _timestamps(seed, n))) + "\n")
        if name != "c":
            (d / "camera_timestamps.csv").write_text(
                "timestamp\n" + "\n".join(map(str, _timestamps(seed + 5, n))) + "\n")
    for x in "abc":
        for y in "abc":
            got = datadiff.diff_dirs(str(tmp_path / x), str(tmp_path / y), 0.01)
            assert got == jax_datadiff.diff_dirs(str(tmp_path / x), str(tmp_path / y), 0.01)
            assert bool(got) == (x != y)


def test_invariant_mask_matches_jax():
    rng = np.random.default_rng(9)
    base = rng.random((8, 16, 3)).astype(np.float32)
    frames = []
    for _ in range(5):
        f = base.copy()
        f[:4] = rng.random((4, 16, 3))
        f[6, 3, 1] = rng.random()
        frames.append(f)
    got, want = invariant_mask.build_invariant_mask(frames), jax_invariant.build_invariant_mask(frames)
    np.testing.assert_array_equal(got, want)
    assert want[4:].sum() == 4 * 16 * 3 - 1 and not want[:4].all()
    with pytest.raises(AssertionError, match="no frames"):
        invariant_mask.InvariantMaskBuilder().result()


def test_overlays_need_only_the_renders_numpy_without_a_pose(scene, monkeypatch):
    """The renders the viewer pushes run without cv2 (the card's host has
    none); an overlay imports it and raises ImportError naming it."""
    import sys

    image, bev = scene
    monkeypatch.setitem(sys.modules, "cv2", None)
    viz.render_range_view(image, spec=SPEC)
    viz.render_bev(bev)
    viz.render_class_mask(image[..., 0] > 0)
    with pytest.raises(ImportError, match="cv2"):
        viz.render_range_view(image, *POSES["ahead"], spec=SPEC)
    with pytest.raises(ImportError, match="cv2"):
        crops.extract_crops(np.zeros((1, 8, 8), np.uint8), _poses()[:1], None, "unused")
