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
import inspect
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


_FORBIDDEN = ("tpufusion", "jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes")


def _is_jax_package(module: str | None) -> bool:
    """The JAX package, or JAX and the libraries its trainers are built on,
    or ml_dtypes (JAX's small floats: the port keeps its own table of
    them, `ops/small_float.py`, and the card's machine has no ml_dtypes)."""
    return module is not None and module.split(".")[0] in _FORBIDDEN


def test_importing_every_port_module_loads_no_jax_package():
    """In a fresh interpreter, import every module of tpufusion_torch (the
    training modules among them): neither tpufusion nor jax, flax, optax,
    orbax or ml_dtypes is loaded."""
    code = textwrap.dedent(
        """
        import pkgutil, sys
        import tpufusion_torch
        names = [m.name for m in pkgutil.walk_packages(tpufusion_torch.__path__, "tpufusion_torch.")]
        for name in names:
            __import__(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("tpufusion", "jax", "jaxlib", "flax", "optax", "orbax",
                                            "ml_dtypes"))
        assert not bad, bad
        for name in ("train.trainer", "train.fusion_trainer", "train.optim", "train.checkpoint",
                     "train.train_step", "train.stats", "train.pr_curves", "data.pipeline",
                     "data.augment", "models.losses", "models.metrics", "parallel.mesh",
                     "parallel.dryrun", "parallel.halo", "tools.detector_envelope", "tools.import_keras",
                     "native", "data.lz4", "data.rosmsg", "data.rosbag_reader", "data.registry",
                     "data.reference_reader", "data.etl", "utils.logging", "cli",
                     "tools.rehearse_bag_pipeline", "tools.train_synthetic_detector",
                     "tools.tune_detector_asset", "tools.fit_oracle_sensitivity",
                     "tools.train_fusion_synthetic", "tools.bench_camera_full", "serve.jpeg",
                     "serve.viewer", "tools.analyze", "tools.calibrate", "tools.crops",
                     "tools.datadiff", "tools.invariant_mask", "tools.visualize", "bench", "entry"):
            assert "tpufusion_torch." + name in names, name
        print("IMPORTED", len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split("IMPORTED")[1]) >= 86


def test_numpy_host_tools_import_without_torch():
    """The numpy host tools and the JPEG encoder load without torch (the
    subpackages' torch-backed exports load on first use)."""
    code = textwrap.dedent(
        """
        import sys
        import tpufusion_torch.data.registry, tpufusion_torch.serve.jpeg
        import tpufusion_torch.tools.datadiff, tpufusion_torch.tools.invariant_mask
        import tpufusion_torch.tools.analyze, tpufusion_torch.cli
        assert "torch" not in sys.modules, sorted(m for m in sys.modules if m.startswith("torch"))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_never_imports_the_jax_package(path):
    """AST scan: no `import tpufusion...`, no `from tpufusion... import`,
    none of jax, flax, optax, orbax or ml_dtypes either, and no importlib /
    __import__ / exec loading of other files."""
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


# -- host scalars on the serving path ------------------------------------------------------

_DEVICE_CONSTANT_SITES = {  # where a constant tensor is made inside a serving step
    "geometry/bev.py": "_bucketize",
    "decode/decode.py": ("corner_vote", "_silhouette_center"),
    "ops/projection.py": "gather_image",
}


@pytest.mark.parametrize("rel", sorted(_DEVICE_CONSTANT_SITES))
def test_serving_sites_make_no_host_scalars_on_the_card(rel):
    """torch.tensor(<python number>, device=...) on the card is a pageable
    host copy and a cudaStreamSynchronize: these sites fill on the device
    (torch.full) or read a cached device constant (_constants.py) instead."""
    names = _DEVICE_CONSTANT_SITES[rel]
    names = (names,) if isinstance(names, str) else names
    with open(os.path.join(PORT_DIR, rel)) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    for name in names:
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                call = ast.unparse(node.func)
                assert call not in ("torch.tensor", "torch.as_tensor"), (rel, name, node.lineno)


def test_device_constants_are_made_once():
    import torch

    from tpufusion_torch._constants import device_constant

    with torch.inference_mode():
        a = device_constant((0.03, 0.97), torch.float32, "cpu")
    b = device_constant([0.03, 0.97], torch.float32, torch.device("cpu"))
    assert a is b and not a.is_inference()  # usable outside inference mode too
    assert torch.equal(a, torch.tensor([0.03, 0.97], dtype=torch.float32))


# -- the dataset on disk: the registry, the reference-layout reader, logging -----------------

from tpufusion.data import reference_reader as jax_reference_reader  # noqa: E402
from tpufusion.data import registry as jax_registry  # noqa: E402
from tpufusion.utils import logging as jax_logging  # noqa: E402
from tpufusion_torch.data import reference_reader as port_reference_reader  # noqa: E402
from tpufusion_torch.data import registry as port_registry  # noqa: E402
from tpufusion_torch.utils import logging as port_logging  # noqa: E402


def _reference_layout_dir(root, seed=5, frames=4, hw=(32, 201)):
    """A dataset dir in the reference's extracted layout: py2-style pickles a
    channel, the timestamp, pose and radar CSVs; and a registry naming it."""
    import pickle

    rng = np.random.default_rng(seed)
    d = root / "bag1"
    (d / "lidar_360").mkdir(parents=True)
    (d / "radar").mkdir()
    stamps = [1490000000000 + 100_000 * i for i in range(frames)]
    for ts in stamps:
        for ch in ("distance", "height", "intensity"):
            with open(d / "lidar_360" / f"{ts}_{ch}_float.lidar.p", "wb") as f:
                pickle.dump(rng.uniform(-2, 60, hw).astype(np.float64).tolist(), f, protocol=2)
    (d / "lidar_timestamps.csv").write_text("timestamp\n" + "\n".join(map(str, stamps)) + "\n")
    rows = ["timestamp,tx,ty,tz,rx,ry,rz"] + [
        f"{ts},{rng.uniform(5, 30):.6f},{rng.uniform(-9, 9):.6f},-0.7,0,0,{rng.uniform(-1, 1):.6f}"
        for ts in stamps]
    (d / "obs_poses_interp_transform.csv").write_text("\n".join(rows) + "\n")
    (d / "radar" / "radar_tracks.csv").write_text("timestamp,range,angle\n5,20.5,-3.25\n9,31,4\n")
    (root / "meta.csv").write_text("l,w,h\n4.2,1.6,1.5\n")
    (root / "registry.csv").write_text("# a comment\nbag1,meta.csv\n\nbag1,meta.csv\n")
    return d, stamps


def test_registry_and_reference_reader_copies_match(tmp_path):
    d, stamps = _reference_layout_dir(tmp_path)
    got = list(port_registry.read_registry(str(tmp_path / "registry.csv"), str(tmp_path)))
    want = list(jax_registry.read_registry(str(tmp_path / "registry.csv"), str(tmp_path)))
    assert [dataclasses.asdict(g) for g in got] == [dataclasses.asdict(w) for w in want]
    assert len(got) == 2 and got[0].obstacle_size == want[0].obstacle_size == (4.2, 1.6, 1.5)
    poses = str(d / "obs_poses_interp_transform.csv")
    assert port_registry.load_pose_csv(poses) == jax_registry.load_pose_csv(poses)
    for mod in ("load_timestamps", "load_radar_tracks"):
        assert getattr(port_reference_reader, mod)(str(d)) == getattr(jax_reference_reader, mod)(str(d))
    np.testing.assert_array_equal(port_reference_reader.load_lidar_frame(str(d), stamps[1]),
                                  jax_reference_reader.load_lidar_frame(str(d), stamps[1]))
    port_arrays = port_reference_reader.ReferenceDirDataset(got[0]).to_arrays()
    jax_arrays = jax_reference_reader.ReferenceDirDataset(want[0]).to_arrays()
    assert sorted(port_arrays) == sorted(jax_arrays)
    for k in jax_arrays:
        assert port_arrays[k].dtype == jax_arrays[k].dtype, k
        np.testing.assert_array_equal(port_arrays[k], jax_arrays[k], err_msg=k)
    assert port_arrays["image"].shape == (4, 32, 201, 3)
    from tpufusion_torch.data import DirSet, read_registry

    assert DirSet is port_registry.DirSet and read_registry is port_registry.read_registry


def test_logging_copy_matches():
    import logging

    port, ref = port_logging.get_logger("etl"), jax_logging.get_logger("etl")
    assert port.name == "tpufusion_torch.etl" and ref.name == "tpufusion.etl"
    (ph,), (rh,) = logging.getLogger("tpufusion_torch").handlers, logging.getLogger("tpufusion").handlers
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "extracted %s", ("dir",), None)
    assert ph.formatter.format(record) == rh.formatter.format(record)
    for name in ("tpufusion_torch", "tpufusion"):
        root = logging.getLogger(name)
        assert root.level == logging.INFO and root.propagate is False
    assert port_logging.get_logger("etl") is port  # configured once
    assert len(logging.getLogger("tpufusion_torch").handlers) == 1


# -- completeness: the port has a counterpart of every public name of the JAX package ---------

JAX_DIR = os.path.join(REPO, "tpufusion")
NOT_CARRIED_OVER = {  # a JAX name or module -> its item in ROADMAP's "Do not carry over" list
    "utils/profiling.py": "`utils/profiling.py`",
    "tools/probe_h2d_leak.py": "`tools/probe_h2d_leak.py`",
}
RENAMED = {  # a JAX name -> its counterpart in the port, under another name or module
    # the "exact" z-buffer and its Pallas kernel are one wrapper (kernel / plain version)
    "ops/scatter.py::nearest_wins_sort": "ops/projection.py::nearest_wins_image_reference",
    "ops/pallas_projection.py::nearest_wins_pallas_batch": "ops/projection.py::nearest_wins_image",
    "ops/pallas_cc.py::propagate_pallas": "ops/cc.py::connected_components_with_bbox",
    # the bag codec's loader: a ctypes library built by cc, not a CPython extension
    "native/__init__.py::get_fastpoints": "native/__init__.py::load",
    # an nnx parameter filter -> the parameters torch's optimizer takes
    "models/fusion.py::trainable_filter": "models/fusion.py::trainable_parameters",
    # jax.nn.softmax inside the imported network -> the softmax of its forward
    "tools/import_keras.py::jax_softmax": "tools/import_keras.py::ShippedLidarFCN",
    # numpy generators and the inference loop, kept where the port's callers import them
    "tools/train_fusion_synthetic.py::render_camera_frames": "data/synthetic.py::render_camera_frames",
    "train/fusion_trainer.py::build_fusion_batches": "data/fusion.py::build_fusion_batches",
    "train/fusion_trainer.py::predict_fusion": "serve/fusion.py::predict_fusion",
}

# The repo-root files of the JAX package's headline, which the walk of
# `tpufusion/` does not see: each public name -> its counterpart in the port
ROOT_COUNTERPARTS = {
    "bench.py::main": "bench.py::main",
    "bench.py::log": "bench.py::log",
    "__graft_entry__.py::entry": "entry.py::entry",
    "__graft_entry__.py::dryrun_multichip": "entry.py::dryrun_multichip",
}
ROOT_NOT_CARRIED_OVER = {"bench.py::force": "`bench.py`'s `force`"}


def _jax_modules():
    out = []
    for root, _, names in os.walk(JAX_DIR):
        out += [os.path.relpath(os.path.join(root, n), JAX_DIR) for n in names if n.endswith(".py")]
    return sorted(out)


def _public_defs(path: str) -> list[str]:
    tree = ast.parse(open(path).read(), path)
    return [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")]


def _top_level_names(path: str) -> set[str]:
    names = set()
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return names


def _do_not_carry_over_section() -> str:
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    return text.split("**Do not carry over.**", 1)[1].split("###", 1)[0]


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_of_the_jax_package_has_a_counterpart(rel):
    """Each public top-level function and class of a JAX module has one of
    the same name in the port's module of the same path, or is a named
    rename (whose target exists) or an item of ROADMAP's "Do not carry
    over" list."""
    section = _do_not_carry_over_section()
    if rel in NOT_CARRIED_OVER:
        assert NOT_CARRIED_OVER[rel] in section, rel
        return
    port = os.path.join(PORT_DIR, rel)
    have = _top_level_names(port) if os.path.exists(port) else set()
    for name in _public_defs(os.path.join(JAX_DIR, rel)):
        key = f"{rel}::{name}"
        if key in NOT_CARRIED_OVER:
            assert " ".join(NOT_CARRIED_OVER[key].split()) in " ".join(section.split()), key
        elif key in RENAMED:
            target_rel, target = RENAMED[key].split("::")
            assert target in _top_level_names(os.path.join(PORT_DIR, target_rel)), RENAMED[key]
        else:
            assert name in have, f"tpufusion_torch/{rel} lacks {name}"


@pytest.mark.parametrize("rel", sorted({k.split("::")[0] for k in ROOT_COUNTERPARTS}))
def test_every_public_name_of_the_repo_root_files_has_a_counterpart(rel):
    """Each public top-level function and class of the repo-root
    `bench.py` and `__graft_entry__.py` has its counterpart in the port
    (ROOT_COUNTERPARTS, whose target exists) or is an item of ROADMAP's
    "Do not carry over" list."""
    section = " ".join(_do_not_carry_over_section().split())
    for name in _public_defs(os.path.join(REPO, rel)):
        key = f"{rel}::{name}"
        if key in ROOT_NOT_CARRIED_OVER:
            assert ROOT_NOT_CARRIED_OVER[key] in section, key
            continue
        assert key in ROOT_COUNTERPARTS, f"{key} has no counterpart in the port"
        target_rel, target = ROOT_COUNTERPARTS[key].split("::")
        assert target in _top_level_names(os.path.join(PORT_DIR, target_rel)), ROOT_COUNTERPARTS[key]


def test_the_exceptions_are_still_needed():
    """Every exception names a JAX name that exists and that the port's
    module of the same path does not define; every repo-root entry names
    a public name its file still defines."""
    for key in list(ROOT_COUNTERPARTS) + list(ROOT_NOT_CARRIED_OVER):
        rel, _, name = key.partition("::")
        assert name in _public_defs(os.path.join(REPO, rel)), key
    for key in list(NOT_CARRIED_OVER) + list(RENAMED):
        rel, _, name = key.partition("::")
        assert os.path.exists(os.path.join(JAX_DIR, rel)), key
        if name:
            assert name in _public_defs(os.path.join(JAX_DIR, rel)), key
            port = os.path.join(PORT_DIR, rel)
            assert not os.path.exists(port) or name not in _top_level_names(port), key
        else:
            assert not os.path.exists(os.path.join(PORT_DIR, rel)), key


def _jax_subpackages():
    return sorted(rel[: -len("/__init__.py")] for rel in _jax_modules() if rel.endswith("/__init__.py"))


@pytest.mark.parametrize("package", _jax_subpackages())
def test_every_subpackage_exports_the_jax_packages_names(package):
    """What a JAX subpackage's __init__ exports (`__all__`), the port's
    exports too (in its `__all__`, importable), but the names not carried
    over."""
    import importlib

    tree = ast.parse(open(os.path.join(JAX_DIR, package, "__init__.py")).read())
    exported = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__" for t in node.targets):
            exported = ast.literal_eval(node.value)
    mod = importlib.import_module(f"tpufusion_torch.{package}")
    for name in exported:
        if any(key.endswith(f"::{name}") for key in NOT_CARRIED_OVER):
            assert name not in getattr(mod, "__all__", ()), name
            continue
        assert name in mod.__all__ and getattr(mod, name) is not None, (package, name)


# -- signatures: each counterpart takes the JAX package's calls ---------------------------------

_KEYS = "a `jax.random` key -> a generator (numpy's or torch's): the two draw different numbers"
_RNGS = "an `nnx.Rngs` -> nothing: the port's modules are filled by weights or `uniform_init_`"
_SPLIT = "nnx's graphdef / state pair -> the torch module, which holds both"
SIGNATURE_EXCEPTIONS = {
    # a JAX name -> (its parameters the port does not take, the port's parameters in their
    # place, why); (None, None, why): a counterpart of another contract, not compared
    "predict.py::make_e2e_step": ({"graphdef"}, {"model"}, _SPLIT),
    "tools/detector_envelope.py::run_condition": ({"graphdef", "state"}, {"model"}, _SPLIT),
    "tools/train_synthetic_detector.py::prepare_eval_batches": (
        {"graphdef", "state"}, {"model"}, _SPLIT),
    "tools/train_synthetic_detector.py::evaluate": ({"graphdef", "state"}, {"model"}, _SPLIT),
    "ops/components.py::connected_components_with_bbox": (
        {"impl"}, set(), "one wrapper: the kernel on CUDA tensors, the plain sweeps on the CPU"),
    "parallel/mesh.py::make_mesh": (
        {"devices"}, {"device", "backend"}, "torch.distributed ranks, not a list of JAX devices"),
    "data/augment.py::sample_roll": ({"key"}, {"generator"}, _KEYS),
    "data/augment.py::transform_point_cloud": ({"key"}, {"generator"}, _KEYS),
    "data/augment.py::augment_batch": ({"key"}, {"generator"}, _KEYS),
    "data/synthetic.py::synthesize_points_batch": ({"key"}, {"rng"}, _KEYS),
    "data/synthetic.py::synthesize_multi_vehicle_batch": ({"key"}, {"rng"}, _KEYS),
    "data/synthetic.py::synthesize_tracking_sequence": ({"key"}, {"rng"}, _KEYS),
    "data/synthetic.py::synthesize_beam_scan_batch": ({"key"}, {"rng"}, _KEYS),
    "data/synthetic.py::synthesize_beam_multi_vehicle_batch": ({"key"}, {"rng"}, _KEYS),
    "data/synthetic.py::synthesize_beam_tracking_sequence": ({"key"}, {"rng"}, _KEYS),
    "models/fcn.py::FCN": ({"rngs"}, {"seed"}, "an `nnx.Rngs` -> the seed of `uniform_init_`"),
    "models/fusion.py::FusionNet": ({"rngs"}, set(), _RNGS),
    "tools/import_keras.py::ShippedLidarFCN": ({"rngs"}, set(), _RNGS),
    "models/fusion.py::trainable_filter": (
        set(), {"net"}, "an nnx filter -> the net's parameters that torch's optimizer takes"),
    "train/fusion_trainer.py::make_fusion_tx": (
        set(), {"params"}, "optax builds a transformation alone; torch's optimizer needs its "
        "parameters"),
    "ops/scatter.py::nearest_wins_sort": (None, None, "RENAMED: the z-buffer's plain version"),
    "ops/pallas_projection.py::nearest_wins_pallas_batch": (
        None, None, "RENAMED: the z-buffer kernel's wrapper"),
    "ops/pallas_cc.py::propagate_pallas": (None, None, "RENAMED: the CC kernel's wrapper"),
    "tools/import_keras.py::jax_softmax": (None, None, "RENAMED: the network's forward"),
    "models/fcn.py::SampleWiseBN.__call__": (
        {"use_running_average"}, {"train"},
        "flax's BatchNorm keyword -> the port's modules' `train` flag, which FCN.forward passes "
        "down (train = not use_running_average)"),
}


def _module(rel: str, package: str):
    import importlib

    name = rel[: -len(".py")].replace("/", ".")
    name = name[: -len("__init__")].rstrip(".") if name.endswith("__init__") else name
    return importlib.import_module(f"{package}.{name}" if name else package)


def _parameters(obj) -> list:
    """A function's parameters, or a class's `__init__`'s without self."""
    params = list(inspect.signature(obj.__init__ if inspect.isclass(obj) else obj).parameters.values())
    return params[1:] if inspect.isclass(obj) else params


def _same_default(a, b) -> bool:
    if dataclasses.is_dataclass(a) or dataclasses.is_dataclass(b):
        return repr(a) == repr(b)
    try:
        return bool(a == b)
    except Exception:
        return repr(a) == repr(b)


def _signature_faults(jax_params, port_params) -> list[str]:
    """What a call of the JAX signature would not find in the port's: the
    JAX positional parameters first, by name and in order; its keyword-only
    and variadic ones anywhere; equal defaults; any further parameter of
    the port with a default."""
    P = inspect.Parameter
    positional = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)
    jpos = [p for p in jax_params if p.kind in positional]
    ppos = [p for p in port_params if p.kind in positional]
    by_name = {p.name: p for p in port_params}
    faults = []
    for i, jp in enumerate(jpos):
        got = ppos[i].name if i < len(ppos) else None
        if got != jp.name:
            faults.append(f"positional parameter {i}: {jp.name} in JAX, {got} in the port")
    for jp in jax_params:
        pp = by_name.get(jp.name)
        if pp is None:
            faults.append(f"{jp.name} missing")
        elif jp.kind in (P.VAR_POSITIONAL, P.VAR_KEYWORD) and pp.kind != jp.kind:
            faults.append(f"{jp.name}: {jp.kind} in JAX, {pp.kind} in the port")
        elif jp.kind == P.KEYWORD_ONLY and pp.kind not in (P.KEYWORD_ONLY, P.POSITIONAL_OR_KEYWORD):
            faults.append(f"{jp.name} cannot be passed by keyword")
        elif (jp.default is P.empty) != (pp.default is P.empty) or not _same_default(
                jp.default, pp.default):
            faults.append(f"{jp.name}: default {jp.default!r} in JAX, {pp.default!r} in the port")
    names = {p.name for p in jax_params}
    for pp in port_params:
        if pp.name not in names and pp.default is P.empty and pp.kind in (*positional, P.KEYWORD_ONLY):
            faults.append(f"the port's {pp.name} has no default")
    return faults


def _counterparts(rel: str):
    """(key, JAX object, port object) for each public name of a JAX module
    with a counterpart in the port."""
    if rel in NOT_CARRIED_OVER:
        return []
    names = _public_defs(os.path.join(JAX_DIR, rel))
    if not names:
        return []
    jax_mod = _module(rel, "tpufusion")
    out = []
    for name in names:
        key = f"{rel}::{name}"
        if key in NOT_CARRIED_OVER:
            continue
        target_rel, target = RENAMED.get(key, key).split("::")
        out.append((key, getattr(jax_mod, name), getattr(_module(target_rel, "tpufusion_torch"), target)))
    return out


def _method_parameters(cls, name: str) -> list:
    """A method's parameters as a caller passes them: without self (or
    cls); a staticmethod's all."""
    raw = inspect.getattr_static(cls, name)
    if isinstance(raw, staticmethod):
        return list(inspect.signature(raw.__func__).parameters.values())
    fn = raw.__func__ if isinstance(raw, classmethod) else raw
    return list(inspect.signature(fn).parameters.values())[1:]


def _method_counterparts(rel: str):
    """(key `rel::Class.method`, JAX parameters, the port's parameters) for
    each public method a JAX class of the module defines in its own body,
    `__call__` included: the port's `forward` where the port's class is a
    torch module. A method the port lacks raises AttributeError."""
    import torch

    out = []
    for key, jax_cls, port_cls in _counterparts(rel):
        if not inspect.isclass(jax_cls):
            continue
        for name, raw in vars(jax_cls).items():
            if name.startswith("_") and name != "__call__":
                continue
            if not (inspect.isfunction(raw) or isinstance(raw, (staticmethod, classmethod))):
                continue
            port_name = ("forward" if name == "__call__" and issubclass(port_cls, torch.nn.Module)
                         else name)
            out.append((f"{key}.{name}", _method_parameters(jax_cls, name),
                        _method_parameters(port_cls, port_name)))
    return out


def _faults_with(key, jax_params, port_params, exceptions) -> list[str]:
    removed, added, _ = exceptions.get(key, (set(), set(), ""))
    if removed is None:
        return []
    return _signature_faults([p for p in jax_params if p.name not in removed],
                             [p for p in port_params if p.name not in added])


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_counterpart_takes_the_jax_packages_parameters(rel):
    """For every public function and class of a JAX module with a
    counterpart, the JAX parameters appear in the port in the same order
    with equal defaults (dataclass defaults compared by repr), so a call
    written for the JAX package calls the port alike; the port may add
    parameters after them (`device`, `mesh`, ...). Exceptions:
    SIGNATURE_EXCEPTIONS, each with its reason."""
    for key, jax_obj, port_obj in _counterparts(rel):
        faults = _faults_with(key, _parameters(jax_obj), _parameters(port_obj),
                              SIGNATURE_EXCEPTIONS)
        assert not faults, (key, faults)


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_counterpart_class_takes_the_jax_packages_method_calls(rel):
    """For every public method of a JAX class with a counterpart (flax's
    `__call__` against the torch module's `forward`), the port's method
    exists and takes the JAX parameters as the guard above asks of
    functions. Exceptions: SIGNATURE_EXCEPTIONS, each with its reason."""
    for key, jax_params, port_params in _method_counterparts(rel):
        faults = _faults_with(key, jax_params, port_params, SIGNATURE_EXCEPTIONS)
        assert not faults, (key, faults)


def test_the_signature_exceptions_are_still_needed():
    """Every entry of SIGNATURE_EXCEPTIONS names a counterpart or a method
    whose signature the guard would refuse without it."""
    found = {}
    for rel in {key.split("::")[0] for key in SIGNATURE_EXCEPTIONS}:
        found.update({key: (_parameters(j), _parameters(p)) for key, j, p in _counterparts(rel)})
        found.update({key: (j, p) for key, j, p in _method_counterparts(rel)})
    for key, (removed, added, why) in SIGNATURE_EXCEPTIONS.items():
        assert key in found and why, key
        if removed is not None:
            assert _faults_with(key, *found[key], {}), f"{key}: the exception is not needed"
        else:
            assert key in RENAMED, key


# -- command lines: each `main` has the JAX package's flags and defaults ------------------------

PORT_ONLY_FLAGS = {
    "device": "every entry point of the port runs on the card unless the caller asks for the CPU",
    "streaming": "the rehearsal's streaming extraction, which the port's ETL adds",
}
_TO_PORT_ASSETS = "the port's outputs and caches go under tpufusion_torch/, never into the JAX package"
FLAG_EXCEPTIONS = {
    # `rel::subcommand dest` (no subcommand: `rel::dest`) -> why its default differs
    "tools/train_synthetic_detector.py::out": _TO_PORT_ASSETS,
    "tools/tune_detector_asset.py::asset": _TO_PORT_ASSETS,
    "tools/train_fusion_synthetic.py::out": _TO_PORT_ASSETS,
    "tools/train_fusion_synthetic.py::cache_dir": (
        "the port's fusion dataset cache (key ending in torch-v1) lives under "
        "tpufusion_torch/assets/, not the reference's /tmp one"),
}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def _flag_defaults(parser, prefix: str = "") -> dict:
    """{`subcommand dest`: default} of an argparse parser, its subparsers'
    flags under their command's name."""
    import argparse

    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            for name, sub in action.choices.items():
                out.update(_flag_defaults(sub, f"{prefix}{name} "))
        elif not isinstance(action, argparse._HelpAction):
            out[prefix + action.dest] = action.default
    return out


def _main_flags(module, monkeypatch) -> dict:
    """The flag defaults of `module.main`'s parser: main runs until it
    parses its (empty) command line, where it stops."""
    import argparse

    def parse(self, *args, **kwargs):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse)
        with pytest.raises(_Parsed) as parsed:
            module.main([])
    return _flag_defaults(parsed.value.parser)


def _jax_mains() -> list[str]:
    return [rel for rel in _jax_modules()
            if rel not in NOT_CARRIED_OVER and "main" in _public_defs(os.path.join(JAX_DIR, rel))]


def _flag_faults(rel: str, monkeypatch) -> dict[str, str]:
    want = _main_flags(_module(rel, "tpufusion"), monkeypatch)
    got = _main_flags(_module(rel, "tpufusion_torch"), monkeypatch)
    faults = {}
    for dest, default in want.items():
        if dest not in got:
            faults[dest] = "missing"
        elif not _same_default(default, got[dest]):
            faults[dest] = f"default {default!r} in JAX, {got[dest]!r} in the port"
    for dest in set(got) - set(want):
        if dest.split(" ")[-1] not in PORT_ONLY_FLAGS:
            faults[dest] = "only in the port"
    return faults


@pytest.mark.parametrize("rel", _jax_mains())
def test_every_main_takes_the_jax_packages_flags_and_defaults(rel, monkeypatch):
    """Each `main` of the JAX package (the CLI's subcommands included)
    and the port's of the same path parse the same flags with equal
    defaults, so the same command line runs the same work. The port may
    add PORT_ONLY_FLAGS; FLAG_EXCEPTIONS names the defaults that differ,
    each with its reason."""
    faults = {dest: why for dest, why in _flag_faults(rel, monkeypatch).items()
              if f"{rel}::{dest}" not in FLAG_EXCEPTIONS}
    assert not faults, (rel, faults)


def test_the_flag_exceptions_are_still_needed(monkeypatch):
    """Every FLAG_EXCEPTIONS entry names a flag whose default differs, and
    every PORT_ONLY_FLAGS entry is a flag some port's main adds."""
    added = set()
    for rel in _jax_mains():
        faults = _flag_faults(rel, monkeypatch)
        added |= {dest.split(" ")[-1] for dest in _main_flags(_module(rel, "tpufusion_torch"),
                                                              monkeypatch)}
        for key in FLAG_EXCEPTIONS:
            if key.startswith(f"{rel}::"):
                assert key.split("::")[1] in faults, f"{key}: the exception is not needed"
    assert {key.split("::")[0] for key in FLAG_EXCEPTIONS} <= set(_jax_mains())
    assert set(PORT_ONLY_FLAGS) <= added
