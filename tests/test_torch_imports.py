"""The port stands alone: it imports nothing of the JAX package.

`tpufusion_torch` and `chip_smoke.py` run on a machine without JAX, and
keep their own copies of what they need from the JAX package (the config
dataclasses, the numpy tracker and scoring, the camera model, the
timestamp alignment, the radar tracks, the interpolation, the tracklet
XML and the submission writers). These tests hold the port to
that and hold each copy equal to its original. Tolerance for the scoring:
1e-6 (the copy runs the same float64 numpy code, so it reads 0); the
other copies are held exactly (same arrays, same bytes written).
"""

import ast
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tpufusion.config as jax_config
import tpufusion_torch.config as port_config
from tests.torch_golden import REPO, to_jax_config, to_port_config
from tpufusion.eval import scoring as jax_scoring
from tpufusion_torch.eval import scoring as port_scoring

PORT_DIR = os.path.join(REPO, "tpufusion_torch")
CONFIG_CLASSES = sorted(
    name for name, obj in vars(port_config).items()
    if dataclasses.is_dataclass(obj) and obj.__module__ == port_config.__name__
)


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _is_jax_package(module: str | None) -> bool:
    return module is not None and (module == "tpufusion" or module.startswith("tpufusion."))


def test_importing_every_port_module_loads_no_jax_package():
    """In a fresh interpreter, import every module of tpufusion_torch:
    neither tpufusion nor jax nor flax is loaded."""
    code = textwrap.dedent(
        """
        import pkgutil, sys
        import tpufusion_torch
        names = [m.name for m in pkgutil.walk_packages(tpufusion_torch.__path__, "tpufusion_torch.")]
        for name in names:
            __import__(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("tpufusion", "jax", "flax"))
        assert not bad, bad
        print("IMPORTED", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split("IMPORTED")[1]) >= 20


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_never_imports_the_jax_package(path):
    """AST scan: no `import tpufusion...`, no `from tpufusion... import`,
    and no importlib / __import__ / exec loading of other files."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                assert not _is_jax_package(alias.name), (path, node.lineno)
                assert alias.name.split(".")[0] not in ("importlib", "runpy"), (path, node.lineno)
        elif isinstance(node, ast.ImportFrom):
            assert not _is_jax_package(node.module), (path, node.lineno)
            assert (node.module or "").split(".")[0] not in ("importlib", "runpy"), (path, node.lineno)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in ("__import__", "exec"), (path, node.lineno)


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copy_has_the_reference_fields_and_defaults(name):
    port_cls, jax_cls = getattr(port_config, name), getattr(jax_config, name)
    got = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(port_cls)]
    want = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(jax_cls)]
    # nested defaults are instances of each package's own class: compare by value
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (field, _, g, gf), (_, _, w, wf) in zip(got, want):
        if dataclasses.is_dataclass(w):
            assert to_port_config(w) == g, field
        else:
            assert g == w and gf == wf, field
    assert port_cls.__dataclass_params__.frozen and jax_cls.__dataclass_params__.frozen


@pytest.mark.parametrize("kw", [{}, {"res_h_deg": 1.8}, {"res_v_deg": 2.0, "vfov_lo_deg": -25.0}])
def test_range_view_spec_derived_values_match(kw):
    port, ref = port_config.RangeViewSpec(**kw), jax_config.RangeViewSpec(**kw)
    for prop in ("res_v_rad", "res_h_rad", "x_min", "y_min", "x_max", "y_max", "width", "height"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    bev_p, bev_j = port_config.BevSpec(), jax_config.BevSpec()
    assert (bev_p.nx, bev_p.ny) == (bev_j.nx, bev_j.ny)


def test_default_pipeline_config_round_trips():
    """DEFAULT and PipelineConfig.replace match, and the converters each
    way give the other package's classes with equal values."""
    assert to_port_config(jax_config.DEFAULT) == port_config.DEFAULT
    assert to_jax_config(port_config.DEFAULT) == jax_config.DEFAULT
    dcfg = port_config.DecodeConfig(min_prob=0.8)
    changed = port_config.DEFAULT.replace(decode=dcfg)
    assert type(changed.decode) is port_config.DecodeConfig and changed.decode.min_prob == 0.8
    assert type(to_jax_config(changed).decode) is jax_config.DecodeConfig
    assert to_jax_config(changed) == jax_config.DEFAULT.replace(decode=to_jax_config(dcfg))


def _poses(seed, frames=12, k=4, vehicles=2):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-30, 30, (frames, vehicles, 3))
    yaws = rng.uniform(-np.pi, np.pi, (frames, vehicles))
    sizes = np.tile([4.2, 1.6, 1.5], (frames, vehicles, 1)) + rng.normal(0, 0.1, (frames, vehicles, 3))
    poses = np.zeros((frames, k, 7))
    poses[:, :vehicles, :3] = centers + rng.normal(0, 0.8, centers.shape)
    poses[:, :vehicles, 3] = yaws + rng.normal(0, 0.3, yaws.shape)
    poses[:, :vehicles, 4:] = sizes
    poses[:, vehicles:] = rng.uniform(-30, 30, (frames, k - vehicles, 7))  # clutter
    found = rng.random((frames, k)) < 0.8
    return poses.astype(np.float32), found, centers, yaws, sizes


@pytest.mark.parametrize("pose_frame", ["orbit", "physical"])
@pytest.mark.parametrize("seed", [0, 1])
def test_score_multi_poses_matches_the_reference(seed, pose_frame):
    poses, found, centers, yaws, sizes = _poses(seed)
    got = port_scoring.score_multi_poses(poses, found, centers, yaws, sizes, pose_frame=pose_frame)
    want = jax_scoring.score_multi_poses(poses, found, centers, yaws, sizes, pose_frame=pose_frame)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    assert want["box_recall"] > 0


def test_scoring_helpers_match_the_reference():
    poses, *_ = _poses(2)
    flat = poses.reshape(-1, 7)
    for fn in ("orbit_to_physical", "physical_to_orbit"):
        np.testing.assert_allclose(
            getattr(port_scoring, fn)(poses), getattr(jax_scoring, fn)(poses), rtol=0, atol=1e-6
        )
    for a, b in zip(flat[:-1], flat[1:]):
        assert abs(port_scoring.box_iou_3d(a, b) - jax_scoring.box_iou_3d(a, b)) <= 1e-6
        assert port_scoring.pose_errors(a, b) == jax_scoring.pose_errors(a, b)
    same = flat[0].copy()
    assert port_scoring.box_iou_3d(same, same) == pytest.approx(1.0)


# -- the numpy copies this port keeps of the JAX package's host modules ------

from tpufusion.data import align as jax_align  # noqa: E402
from tpufusion.data import radar as jax_radar  # noqa: E402
from tpufusion.eval import interpolate as jax_interpolate  # noqa: E402
from tpufusion.eval import submission as jax_submission  # noqa: E402
from tpufusion.eval import tracklet_xml as jax_tracklet_xml  # noqa: E402
from tpufusion.geometry import boxes as jax_boxes  # noqa: E402
from tpufusion.geometry import camera as jax_camera  # noqa: E402
from tpufusion_torch.data import align as port_align  # noqa: E402
from tpufusion_torch.data import radar as port_radar  # noqa: E402
from tpufusion_torch.eval import interpolate as port_interpolate  # noqa: E402
from tpufusion_torch.eval import submission as port_submission  # noqa: E402
from tpufusion_torch.eval import tracklet_xml as port_tracklet_xml  # noqa: E402
from tpufusion_torch.geometry import boxes as port_boxes  # noqa: E402
from tpufusion_torch.geometry import camera as port_camera  # noqa: E402

_CAMERA_YAML = """
image_width: 1368
image_height: 1096
camera_matrix: {rows: 3, cols: 3, data: [1384.6, 0.0, 697.8, 0.0, 1393.5, 544.2, 0.0, 0.0, 1.0]}
distortion_coefficients: {rows: 1, cols: 5, data: [-0.152, 0.097, 0.002, -0.001, 0.0]}
rectification_matrix: {rows: 3, cols: 3, data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]}
projection_matrix: {rows: 3, cols: 4, data: [1300.1, 0.0, 700.2, 0.0, 0.0, 1350.5, 541.9, 0.0, 0.0, 0.0, 1.0, 0.0]}
"""
_LIDAR2CAM_YAML = """
translation: {data: [0.3, -0.1, -0.4]}
euler_rotations: {data: [-1.55, 0.02, -1.58]}
"""


@pytest.mark.parametrize("axes", ["sxyz", "rzxz", "ryzx", "szyx", "rxyx"])
def test_camera_copy_euler_matrix_matches(axes):
    for angles in ((0.3, -1.1, 2.0), (0.0, 0.0, 0.0), (-2.5, 0.4, 0.9)):
        np.testing.assert_array_equal(
            port_camera.euler_matrix(*angles, axes), jax_camera.euler_matrix(*angles, axes)
        )


def _calibrated_cameras(tmp_path):
    cam_yaml, l2c_yaml = tmp_path / "cam.yaml", tmp_path / "l2c.yaml"
    cam_yaml.write_text(_CAMERA_YAML)
    l2c_yaml.write_text(_LIDAR2CAM_YAML)
    return [
        mod.CameraModel().load_camera_calibration(str(cam_yaml), str(l2c_yaml))
        for mod in (port_camera, jax_camera)
    ]


def test_camera_copy_calibration_and_projection_match(tmp_path):
    port_cam, jax_cam = _calibrated_cameras(tmp_path)
    for attr in ("width", "height", "K", "D", "R", "P", "extrinsic"):
        np.testing.assert_array_equal(getattr(port_cam, attr), getattr(jax_cam, attr))
    pts = np.random.default_rng(0).uniform(-40, 40, (500, 3))
    pts[0] = 0.0  # the degenerate depth
    np.testing.assert_array_equal(
        port_cam.project_lidar_to_pixels(pts), jax_cam.project_lidar_to_pixels(pts)
    )
    rot, trans = [-1.5, 0.1, -1.6], [0.2, 0.0, -0.3, 9.0]
    np.testing.assert_array_equal(
        port_camera.CameraModel().set_extrinsic_from_euler(rot, trans).extrinsic,
        jax_camera.CameraModel().set_extrinsic_from_euler(rot, trans).extrinsic,
    )
    raw = np.random.default_rng(1).integers(0, 255, (1096, 1368), dtype=np.uint8)
    np.testing.assert_array_equal(port_cam.rectify_image(raw), jax_cam.rectify_image(raw))


@pytest.mark.parametrize("margin", [0.25, 0.1])
def test_camera_copy_label_footprint_matches(tmp_path, margin):
    port_cam, jax_cam = (m.synthetic_camera() for m in (port_camera, jax_camera))
    for center in ([15.0, 1.0, -0.7], [9.0, -3.0, -0.5], [25.0, 8.0, -0.9]):
        args = (np.array(center), np.array([4.2, 1.6, 1.5]))
        got = port_camera.camera_label_footprint(*args, port_cam, (512, 1368), 256, margin)
        want = jax_camera.camera_label_footprint(*args, jax_cam, (512, 1368), 256, margin)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_camera_copy_rgb_onto_bev_and_synthetic_camera_match():
    port_cam, jax_cam = (m.synthetic_camera(640, 480, 700.0) for m in (port_camera, jax_camera))
    for attr in ("width", "height", "P", "extrinsic"):
        np.testing.assert_array_equal(getattr(port_cam, attr), getattr(jax_cam, attr))
    img = np.random.default_rng(2).uniform(0, 1, (480, 640, 3)).astype(np.float32)
    kw = dict(max_range=60.0, res_x=0.4, res_y=0.9, ground_z=-1.5)
    got = port_camera.rgb_onto_bev(img, port_cam, 299, 133, **kw)
    want = jax_camera.rgb_onto_bev(img, jax_cam, 299, 133, **kw)
    np.testing.assert_array_equal(got, want)
    assert (want != 0).any()


def test_corner_signs_copy_matches():
    np.testing.assert_array_equal(port_boxes._CORNER_SIGNS, jax_boxes._CORNER_SIGNS)
    assert port_boxes._CORNER_SIGNS.dtype == jax_boxes._CORNER_SIGNS.dtype


@pytest.mark.parametrize("seed", [0, 1])
def test_align_copy_matches(seed):
    rng = np.random.default_rng(seed)
    lidar = np.sort(rng.integers(0, 10**9, 200))
    radar = np.sort(rng.integers(0, 10**9, 350))
    cam = np.sort(rng.integers(-10**7, 10**9 + 10**7, 300))
    cam[:5] = (lidar[:5] + lidar[1:6]) // 2  # ties and near-ties
    got = port_align.align_camera_lidar_radar(cam, lidar, radar)
    want = jax_align.align_camera_lidar_radar(cam, lidar, radar)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(
        port_align.nearest_indices(lidar[:1], cam), jax_align.nearest_indices(lidar[:1], cam)
    )


def test_radar_copy_matches(tmp_path):
    path = tmp_path / "radar.csv"
    rng = np.random.default_rng(3)
    lines = ["timestamp,range,angle,rate,status"]
    lines += [f"{1490000000000 + 50000 * i},{rng.uniform(2, 80):.4f},"
              f"{rng.uniform(-40, 40):.4f},{rng.normal():.3f},{i % 4}" for i in range(40)]
    path.write_text("\n".join(lines) + "\n")
    got, want = port_radar.load_radar_csv(str(path)), jax_radar.load_radar_csv(str(path))
    assert len(got) == len(want) == 40
    np.testing.assert_array_equal(port_radar.radar_features(got), jax_radar.radar_features(want))
    np.testing.assert_array_equal(
        port_radar.radar_timestamps(got), jax_radar.radar_timestamps(want)
    )
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        np.testing.assert_array_equal(g.to_xyz(), w.to_xyz())
    assert port_radar.RADAR_FIELDS == jax_radar.RADAR_FIELDS
    assert port_radar.RADAR_LIDAR_OFFSET == jax_radar.RADAR_LIDAR_OFFSET


def _pose_rows(seed, n=30):
    rng = np.random.default_rng(seed)
    poses = rng.uniform(-30, 30, (n, 7)).astype(np.float32)
    poses[3] = 0.0  # a miss
    ts = (1490000000000 + np.arange(n) * 100_000).tolist()
    cam_ts = (1490000000000 - 150_000 + np.arange(2 * n + 6) * 50_000).tolist()
    return poses, ts, cam_ts


def test_interpolate_copy_matches():
    poses, ts, cam_ts = _pose_rows(0)
    src = [{"timestamp": t, "tx": p[0], "ty": p[1], "tz": p[2], "rz": p[3]}
           for p, t in zip(poses.tolist(), ts)]
    assert port_interpolate.interpolate_poses(src, cam_ts) == \
        jax_interpolate.interpolate_poses(src, cam_ts)


@pytest.mark.parametrize("offset", [None, (0.5, -0.25, 0.1)])
def test_submission_and_tracklet_xml_copies_match(tmp_path, offset):
    """write_predictions_csv, generate_submission (interpolation, NaN
    fill, offset, XML emitter), the parser and write_metadata_csv: the
    copies write the same bytes and parse the same rows."""
    poses, ts, cam_ts = _pose_rows(1)
    meta = {"l": 4.2, "w": 1.6, "h": 1.5}
    out = {}
    for tag, sub, txml, interp in (
        ("port", port_submission, port_tracklet_xml, port_interpolate),
        ("jax", jax_submission, jax_tracklet_xml, jax_interpolate),
    ):
        d = tmp_path / tag
        d.mkdir()
        csv_path, xml_path, ts_path = d / "pred.csv", d / "sub.xml", d / "cam.csv"
        sub.write_predictions_csv(poses, ts, str(csv_path))
        sub.write_predictions_csv(poses[:, :3], ts, str(d / "pred3.csv"))
        sub.write_metadata_csv(poses, str(d / "meta.csv"))
        ts_path.write_text("timestamp\n" + "\n".join(map(str, cam_ts)) + "\n")
        coll = sub.generate_submission(str(csv_path), str(ts_path), meta, str(xml_path), offset)
        parsed = txml.parse_tracklet_xml(str(xml_path))
        out[tag] = {
            "files": {p.name: p.read_bytes() for p in sorted(d.iterdir())},
            "poses": coll.tracklets[0].poses,
            "flat": txml.flatten_tracklets(parsed, cam_ts),
            "loaded_ts": interp.load_timestamps_csv(str(ts_path)),
        }
    assert out["port"] == out["jax"]
    assert len(out["port"]["flat"]) == len(cam_ts)
    nan = np.full((6, 2), np.nan)
    nan[2:4, 0] = [1.0, 2.0]
    np.testing.assert_array_equal(
        port_submission._fill_nans(nan), jax_submission._fill_nans(nan)
    )


@pytest.mark.parametrize("pose_frame", ["orbit", "physical"])
def test_score_poses_copy_matches(pose_frame):
    poses, _, centers, yaws, sizes = _poses(4, frames=24)
    preds = poses[:, 0].copy()
    preds[5] = 0.0  # a miss
    truths = np.concatenate([centers[:, 0], yaws[:, :1], sizes[:, 0]], axis=1)
    got = port_scoring.score_poses(preds, truths, pose_frame=pose_frame)
    want = jax_scoring.score_poses(preds, truths, pose_frame=pose_frame)
    assert got == want
    assert want["detection_rate"] == pytest.approx(23 / 24)
    with pytest.raises(ValueError, match="pose_frame"):
        port_scoring.score_poses(preds, truths, pose_frame="polar")
