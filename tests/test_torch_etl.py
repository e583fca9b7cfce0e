"""The port's dataset ETL and `predict_dataset_dir` against the JAX package.

One synthetic bag, made with numpy from a seed through the port's
`BagWriter` (the reference's writes the same bytes:
`test_torch_rosbag.py`): beam scans whose clouds vary in size, a
duplicate lidar timestamp, an rgb8 camera stream, radar tracks and a
ground-truth tracklet. Both packages extract it, at range-view widths 201
and 1801, in RAM and streaming, as the reference's own tests call its ETL
(`tests/test_rosbag.py`, `tests/test_tools_etl.py::test_etl_roundtrip`).
Tolerances: the range views bit for bit, the camera frames and timestamps
equal, every CSV byte for byte; the BEV's max-height and max-intensity
channels bit for bit and its density within 2^-16 (the ulps of log1p at
the scale of 255: ROADMAP Queue 3); `predict_dataset_dir` with the JAX
model's weights carried across (`models/io.py`): the detections equal,
poses within 1e-4 with yaw compared as an angle
(`_golden.py::wrapped_pose_diff`).
"""

import csv
import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

import tpufusion.data.etl as jax_etl
import tpufusion_torch.data.etl as port_etl
from tests.torch_golden import POSE_ATOL, asset_configs, jax_asset_model, to_jax_config
from tpufusion.config import BevSpec as JaxBevSpec
from tpufusion.config import RangeViewSpec as JaxRangeViewSpec
from tpufusion_torch._golden import wrapped_pose_diff
from tpufusion_torch.config import DEFAULT, BevSpec, RangeViewSpec
from tpufusion_torch.data.rosbag_reader import (
    RADAR_TRACKS_DEFINITION,
    BagWriter,
    serialize_image,
    serialize_pointcloud2,
    serialize_radar_tracks,
)
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.eval.tracklet_xml import Tracklet, TrackletCollection
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import load_state_npz
from tpufusion_torch.predict import predict_dataset_dir

FRAMES = 7
N_POINTS = 32768
CROP = (10, 42)
DENSITY_ATOL = 2.0**-16  # one ulp of float32 in [128, 256)
CSVS = ("lidar_timestamps.csv", "camera_timestamps.csv", "obs_poses_interp_transform.csv",
        "obs_poses_camera.csv", os.path.join("radar", "radar_tracks.csv"))
WIDTHS = {201: dict(res_h_deg=1.8), 1801: {}}


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    """(bag path, tracklet path) of the synthetic drive."""
    d = tmp_path_factory.mktemp("drive")
    rng = np.random.default_rng(8)
    pts, gt, valid = synthesize_beam_scan_batch(rng, FRAMES, N_POINTS)
    w = BagWriter(compression="lz4")
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    w.add_connection(1, "/image_raw", "sensor_msgs/Image")
    w.add_connection(2, "/radar/tracks", "radar_driver/RadarTracks", RADAR_TRACKS_DEFINITION)
    t0 = 1_490_000_000_000_000_000
    tr = Tracklet("Car", l=4.2, w=1.6, h=1.5)
    for i in range(FRAMES):
        ts = t0 + (i if i != 3 else 2) * 100_000_000  # frame 3 repeats frame 2's stamp
        w.add_message(0, ts, serialize_pointcloud2(pts[i][valid[i]]))
        img = rng.integers(0, 255, (64, 80, 3)).astype(np.uint8)
        w.add_message(1, ts + 30_000_000, serialize_image(img, "rgb8"))
        c = gt["center"][i]
        w.add_message(2, ts + 50_000_000, serialize_radar_tracks(
            [{"number": 1, "range": float(np.hypot(c[0], c[1])),
              "angle": float(np.degrees(np.arctan2(c[1], c[0])))}], ts + 50_000_000))
        tr.poses.append({"tx": float(c[0]), "ty": float(c[1]), "tz": float(c[2]),
                         "rx": 0.0, "ry": 0.0, "rz": float(gt["yaw"][i])})
    bag, xml = d / "drive.bag", d / "gt.xml"
    w.write(str(bag))
    TrackletCollection([tr]).write_xml(str(xml))
    return str(bag), str(xml)


_JAX_DIRS: dict = {}


def jax_extracted(drive, tmp_path_factory, width: int, streaming: bool, bev: bool = False) -> str:
    """The JAX package's dataset dir of the drive (made once a setting)."""
    key = (width, streaming, bev)
    if key not in _JAX_DIRS:
        out = str(tmp_path_factory.mktemp("jax") / "ds")
        jax_etl.extract_bag_dataset(
            drive[0], out, tracklet_xml=drive[1], crop=CROP, spec=JaxRangeViewSpec(**WIDTHS[width]),
            bev=JaxBevSpec() if bev else None, streaming=streaming, batch=3)
        _JAX_DIRS[key] = out
    return _JAX_DIRS[key]


def port_extract(drive, out, width, streaming, bev=False):
    return port_etl.extract_bag_dataset(
        drive[0], str(out), tracklet_xml=drive[1], crop=CROP, spec=RangeViewSpec(**WIDTHS[width]),
        bev=BevSpec() if bev else None, streaming=streaming, batch=3, device="cpu")


@pytest.mark.parametrize("streaming", [False, True], ids=["in_ram", "streaming"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_bag_extraction_matches_the_reference(drive, tmp_path, tmp_path_factory, width, streaming):
    report = port_extract(drive, tmp_path, width, streaming)
    want_dir = jax_extracted(drive, tmp_path_factory, width, streaming)
    assert os.path.exists(tmp_path / ("lidar_frames.npy" if streaming else "lidar_frames.npz"))
    got, want = port_etl.load_extracted(str(tmp_path)), jax_etl.load_extracted(want_dir)
    assert got["images"].shape == (FRAMES - 1, 32, width, 3)  # the duplicate dropped
    np.testing.assert_array_equal(np.asarray(got["images"]).view(np.uint32),
                                  np.asarray(want["images"]).view(np.uint32))
    np.testing.assert_array_equal(got["timestamps"], want["timestamps"])
    cam, jcam = port_etl.load_camera_extracted(str(tmp_path)), jax_etl.load_camera_extracted(want_dir)
    assert cam["images"].shape == (FRAMES - 1, CROP[1] - CROP[0], 80)
    np.testing.assert_array_equal(cam["images"], jcam["images"])
    np.testing.assert_array_equal(cam["timestamps"], jcam["timestamps"])
    for name in CSVS:
        assert filecmp.cmp(tmp_path / name, os.path.join(want_dir, name), shallow=False), name
    report.pop("streaming", None)
    assert report == {"frames": FRAMES - 1, "max_gap_s": {"lidar": 0.2, "camera": 0.2},
                      "lidar_gt": FRAMES - 1, "camera_gt": FRAMES - 1}
    # the in-RAM layout of the reference equals either layout of the port
    in_ram = jax_etl.load_extracted(jax_extracted(drive, tmp_path_factory, width, False))
    np.testing.assert_array_equal(np.asarray(got["images"]), in_ram["images"])


def test_bev_frames_match_the_reference_but_the_density_ulps(drive, tmp_path, tmp_path_factory):
    port_extract(drive, tmp_path / "ram", 201, False, bev=True)
    port_extract(drive, tmp_path / "stream", 201, True, bev=True)
    got = np.load(tmp_path / "ram" / "bev_frames.npz")["images"]
    want = np.load(os.path.join(jax_extracted(drive, tmp_path_factory, 201, False, bev=True),
                                "bev_frames.npz"))["images"]
    assert got.shape == want.shape == (FRAMES - 1, BevSpec().nx, BevSpec().ny, 3)
    np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
    np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0)
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=DENSITY_ATOL)
    assert (got[..., 0] > 0).sum() > 1000
    # the streaming layout holds the same BEVs (the reference's streaming
    # BEV raises: it sizes its memmap from fields BevSpec lacks)
    np.testing.assert_array_equal(np.load(tmp_path / "stream" / "bev_frames.npy"), got)
    with pytest.raises(AttributeError, match="height"):
        jax_extracted(drive, tmp_path_factory, 201, True, bev=True)


def test_extract_dataset_from_padded_points_matches_the_reference(tmp_path):
    """The points-NPZ path (`cli extract x.npz`), NaN padding and a
    duplicate stamp included, as `test_tools_etl.py::test_etl_roundtrip`
    calls it; without camera timestamps the tracklet is ignored."""
    rng = np.random.default_rng(3)
    pts, _, valid = synthesize_beam_scan_batch(rng, 6, 4096)
    pts[~valid] = np.nan
    lidar_ts = np.arange(6) * 100_000_000 + 10
    lidar_ts[4] = lidar_ts[3]
    cam_ts = np.arange(6) * 100_000_000 + 55
    t = Tracklet("Car", l=4.2, w=1.6, h=1.5)
    t.poses = [{"tx": 10.0 + i, "ty": -3.0, "tz": -0.7, "rx": 0, "ry": 0, "rz": 0.1} for i in range(6)]
    xml = tmp_path / "gt.xml"
    TrackletCollection([t]).write_xml(str(xml))
    for cams in (cam_ts, None):
        outs = {}
        for tag, etl, spec in (("port", port_etl, RangeViewSpec(res_h_deg=1.8)),
                               ("jax", jax_etl, JaxRangeViewSpec(res_h_deg=1.8))):
            out = tmp_path / f"{tag}_{cams is None}"
            kw = dict(device="cpu") if tag == "port" else {}
            outs[tag] = (out, etl.extract_dataset(str(out), pts, lidar_ts, tracklet_xml=str(xml),
                                                  camera_timestamps=cams, spec=spec, batch=4, **kw))
        (po, prep), (jo, jrep) = outs["port"], outs["jax"]
        assert prep == jrep and prep["frames"] == 5
        got, want = port_etl.load_extracted(str(po)), jax_etl.load_extracted(str(jo))
        np.testing.assert_array_equal(got["images"].view(np.uint32), want["images"].view(np.uint32))
        names = sorted(os.listdir(jo))
        assert sorted(os.listdir(po)) == names
        for name in names:
            if name.endswith(".csv"):
                assert filecmp.cmp(po / name, jo / name, shallow=False), name
        assert ("obs_poses_camera.csv" in names) == (cams is not None)


@pytest.mark.parametrize("encoding", ["mono8", "rgb8", "bgr8"])
def test_camera_frame_and_gap_report_copies_match(encoding):
    rng = np.random.default_rng(6)
    shape = (60, 70) if encoding == "mono8" else (60, 70, 3)
    img = rng.integers(0, 255, shape).astype(np.uint8)
    for crop in ((10, 42), (0, 60)):
        np.testing.assert_array_equal(port_etl.process_camera_frame(img, encoding, None, crop),
                                      jax_etl.process_camera_frame(img, encoding, None, crop))
    streams = {"lidar": rng.integers(0, 10**9, 40), "camera": np.array([5]), "radar": np.array([], int)}
    assert port_etl.max_gap_report(streams) == jax_etl.max_gap_report(streams)


@pytest.mark.parametrize("streaming", [False, True], ids=["in_ram", "streaming"])
def test_predict_dataset_dir_matches_the_reference(drive, tmp_path, tmp_path_factory, streaming):
    """The shipped detector's weights in a JAX model, saved by the JAX
    package's `save_state_npz` and loaded into the port's FCN; both
    packages' `predict_dataset_dir` on the same extracted dir (batch 4:
    one partial batch)."""
    from tpufusion.models.io import save_state_npz as jax_save_state_npz
    from tpufusion.predict import predict_dataset_dir as jax_predict_dataset_dir

    mcfg, dcfg = asset_configs()
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg)
    ds = tmp_path / "ds"
    port_extract(drive, ds, 1801, streaming)
    jax_model = jax_asset_model()
    jax_save_state_npz(str(tmp_path / "w.npz"), jax_model)
    model = FCN(mcfg)
    load_state_npz(str(tmp_path / "w.npz"), model)
    got = predict_dataset_dir(model, str(ds), str(tmp_path / "port"), cfg, batch=4, device="cpu")
    want = jax_predict_dataset_dir(jax_model, str(ds), str(tmp_path / "jax"), to_jax_config(cfg), batch=4)
    assert got["frames"] == want["frames"] == FRAMES - 1
    assert got["detections"] == want["detections"] >= FRAMES - 2

    def rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    prow, jrow = rows(got["predictions_csv"]), rows(want["predictions_csv"])
    assert [r["timestamp"] for r in prow] == [r["timestamp"] for r in jrow]
    keys = ("tx", "ty", "tz", "rz", "l", "w", "h")
    pp = np.array([[float(r[k]) for k in keys] for r in prow])
    jp = np.array([[float(r[k]) for k in keys] for r in jrow])
    assert np.array_equal(pp.any(axis=1), jp.any(axis=1))  # a miss writes a zero pose
    assert wrapped_pose_diff(pp, jp).max() <= POSE_ATOL
    pm, jm = rows(got["metadata_csv"]), rows(want["metadata_csv"])
    assert pm[0].keys() == jm[0].keys()
    # the mean size, written to 4 decimals: the poses' limit plus the rounding
    np.testing.assert_allclose([float(v) for v in pm[0].values()],
                               [float(v) for v in jm[0].values()], rtol=0, atol=POSE_ATOL + 1e-4)
    assert next(model.parameters()).device == torch.device("cpu")
    assert dataclasses.asdict(cfg.model)["head"] == "direct"
