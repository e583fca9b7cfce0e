"""The port's replay server against the JAX main path, and the rule that
every entry point of the port runs on the card unless the caller asks
for the CPU.

ReplayHarness on the CPU takes the same loop as on the card with plain
buffers instead of pinned ones and no streams; what is held here is what
it answers: poses, founds, the frame count and the padding of the last
chunk. Tolerance: POSE_ATOL (1e-4) against JAX make_e2e_step with the
same head.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_golden import (
    ASSET,
    FUSION_ASSET,
    POSE_ATOL,
    asset_configs,
    jax_asset_model,
    jax_step,
    load_npz,
    port_asset_model,
    wrapped_pose_diff,
)
from tpufusion_torch import benchmarks, cli
from tpufusion_torch.config import DEFAULT, LossConfig, MeshConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.data.etl import extract_bag_dataset, extract_dataset, load_extracted
from tpufusion_torch.data.pipeline import BatchPipeline
from tpufusion_torch.data.synthetic import build_fusion_dataset, synthesize_beam_scan_batch
from tpufusion_torch.geometry import encoding
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import fcn_from_arrays, fusion_from_asset
from tpufusion_torch.parallel import dryrun
from tpufusion_torch.parallel.mesh import make_mesh, shard_batch
from tpufusion_torch.predict import make_e2e_step, predict_dataset_dir, predict_images
from tpufusion_torch.serve.fusion import predict_fusion
from tpufusion_torch.serve.pipeline import LidarPipeline
from tpufusion_torch.serve.replay import LatencyStats, ReplayHarness
from tpufusion_torch.train.checkpoint import CheckpointManager
from tpufusion_torch.train.fusion_trainer import train_fusion
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import make_eval_step, make_train_step
from tpufusion_torch.tools import bench_camera_full as tools_camera
from tpufusion_torch.tools import detector_envelope as tools_envelope
from tpufusion_torch.tools import fit_oracle_sensitivity as tools_oracle
from tpufusion_torch.tools import train_fusion_synthetic as tools_fusion
from tpufusion_torch.tools import train_synthetic_detector as tools_trainer
from tpufusion_torch.tools import tune_detector_asset as tools_tuner
from tpufusion_torch.tools.import_keras import load_reference_fcn
from tpufusion_torch.train.trainer import Trainer


def _asset_cfg():
    mcfg, dcfg = asset_configs()
    return DEFAULT.replace(model=mcfg, decode=dcfg)


@pytest.fixture(scope="module")
def frames():
    """5 stored frames (invalid rays parked at the origin, no mask: the
    server replays stored clouds) and JAX's answer with the asset's head."""
    points, _, _ = synthesize_beam_scan_batch(np.random.default_rng(31), 5)
    _, dcfg = asset_configs()
    poses, found = jax_step(jax_asset_model(), dcfg, points, None, head="direct")
    return points, poses, found


@pytest.mark.parametrize("host_ring", [0, 2, 3])
def test_replay_harness_matches_jax_e2e_step(frames, host_ring):
    """5 frames at chunk 2: two full chunks and a padded one."""
    points, want_poses, want_found = frames
    harness = ReplayHarness(_asset_cfg(), port_asset_model(), chunk=2,
                            host_ring=host_ring, device="cpu")
    poses, founds, stats = harness.run(points)
    assert poses.shape == (5, 7) and poses.dtype == np.float32
    assert founds.shape == (5,) and founds.dtype == bool
    np.testing.assert_array_equal(founds, want_found)
    assert wrapped_pose_diff(poses, want_poses).max() <= POSE_ATOL
    assert want_found.sum() >= 3
    assert isinstance(stats, LatencyStats)
    assert len(stats.batch_seconds) == 3 and stats.frames == 6  # the padded chunk counts whole
    summary = stats.summary()
    assert sorted(summary) == ["fps", "frames", "p50_ms_per_frame", "p99_ms_per_frame"]
    assert summary["fps"] > 0 and summary["p99_ms_per_frame"] >= summary["p50_ms_per_frame"]
    if host_ring:
        assert len(harness._ring) == host_ring
        assert all(not host.is_pinned() for host, _, _ in harness._ring)  # CPU: plain buffers


def test_replay_harness_single_chunk_and_profile(frames, tmp_path):
    """Fewer frames than a chunk, and the profiler hook writes its trace."""
    points, want_poses, want_found = frames
    harness = ReplayHarness(_asset_cfg(), port_asset_model(), chunk=4, host_ring=2, device="cpu")
    poses, founds, stats = harness.run(points[:3], profile_dir=str(tmp_path / "trace"))
    np.testing.assert_array_equal(founds, want_found[:3])
    assert wrapped_pose_diff(poses, want_poses[:3]).max() <= POSE_ATOL
    assert len(stats.batch_seconds) == 1
    assert os.path.getsize(tmp_path / "trace" / "replay_trace.json") > 0


def test_replay_harness_takes_the_references_positional_timestamps(frames):
    """`run(points, timestamps)` by position, as the reference's: the
    timestamps are taken and unused, and the answers are JAX's on three
    stored frames at chunk 2. (At 1,024 points a frame neither package
    finds a vehicle, so the frames are the fixture's.)"""
    from tpufusion.serve.replay import ReplayHarness as JaxReplayHarness

    cfg, model, jcfg, jmodel = _corner_pair()
    points = frames[0][:3]
    timestamps = np.arange(3, dtype=np.int64) * 100_000_000
    poses, found, stats = ReplayHarness(cfg, model, chunk=2, device="cpu").run(points, timestamps)
    want_poses, want_found, _ = JaxReplayHarness(jcfg, jmodel, chunk=2).run(points, timestamps)
    assert poses.shape == (3, 7) and stats.frames == 4
    np.testing.assert_array_equal(found, want_found)
    assert want_found.any()
    assert wrapped_pose_diff(poses[found], want_poses[found]).max() <= POSE_ATOL


def _corner_pair():
    """The config and a corner-head model (the asset's trunk) in both
    frameworks: both servers then decode through the corner vote (the
    reference's facade builds its step with the default head)."""
    from tests.make_torch_port_golden import hybrid_corner_arrays
    from tests.torch_golden import jax_model_from_arrays, to_jax_config

    mcfg, arrays = hybrid_corner_arrays()
    cfg = DEFAULT.replace(model=mcfg, decode=asset_configs()[1])
    return (cfg, fcn_from_arrays(arrays, mcfg, device="cpu"), to_jax_config(cfg),
            jax_model_from_arrays(mcfg, arrays))


def test_lidar_pipeline_takes_the_references_positional_call(frames):
    """`LidarPipeline(cfg, model, checkpoint_dir, max_points)` by position,
    as the reference's: the config lands as the config, the model as the
    model, and the answers are JAX's."""
    from tpufusion.serve.pipeline import LidarPipeline as JaxLidarPipeline

    cfg, model, jcfg, jmodel = _corner_pair()
    points = frames[0][:3]
    n = points.shape[1]
    port = LidarPipeline(cfg, model, None, n, device="cpu")
    ref = JaxLidarPipeline(jcfg, jmodel, None, n)
    assert port.cfg is cfg and port.model is model and port.max_points == n
    got = [port.predict_position(p) for p in points]
    want = [ref.predict_position(p) for p in points]
    np.testing.assert_array_equal([g[1] for g in got], [w[1] for w in want])
    assert any(w[1] for w in want)
    assert wrapped_pose_diff(np.stack([g[0] for g in got]),
                             np.stack([w[0] for w in want])).max() <= POSE_ATOL


def test_lidar_pipeline_without_a_model_is_a_fresh_seeded_fcn():
    """`LidarPipeline()` as the reference's: the default config and a
    fresh FCN of it drawn from seed 0 (the reference's initialiser's
    distribution, not its values), answering a request."""
    from tpufusion.serve.pipeline import LidarPipeline as JaxLidarPipeline

    port = LidarPipeline(device="cpu")
    assert port.cfg is DEFAULT and port.max_points == DEFAULT.max_points
    want = FCN(DEFAULT.model, in_channels=3, seed=0).state_dict()
    got = port.model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert float(port.model.conv1.kernel.detach().abs().sum()) > 0  # drawn, not zero
    pose, found = port.predict_position(np.zeros((16, 4), np.float32))
    assert pose.shape == (7,) and isinstance(found, bool)
    JaxLidarPipeline()  # the same call builds the reference's


def test_lidar_pipeline_restores_the_newest_checkpoint(frames, tmp_path):
    """`checkpoint_dir=` restores the newest `ckpt_<step>.pt` into the
    model: the server then answers as one built on those weights."""
    cfg = _asset_cfg()
    older = FCN(cfg.model, in_channels=3, seed=3)
    manager = CheckpointManager(str(tmp_path))
    manager.save(4, older)
    manager.save(9, port_asset_model())
    n = frames[0].shape[1]
    port = LidarPipeline(cfg, checkpoint_dir=str(tmp_path), max_points=n, device="cpu")
    want = port_asset_model().state_dict()
    assert all(torch.equal(port.model.state_dict()[k], want[k]) for k in want)
    plain = LidarPipeline(cfg=cfg, model=port_asset_model(), max_points=n, device="cpu")
    for p in frames[0][:2]:
        got, wnt = port.predict_position(p), plain.predict_position(p)
        assert got[1] == wnt[1] and np.array_equal(got[0], wnt[0])
    with pytest.raises(FileNotFoundError):
        LidarPipeline(cfg, checkpoint_dir=str(tmp_path / "empty"), device="cpu")


def test_replay_harness_takes_the_references_defaults():
    """`ReplayHarness()` as the reference's: the default config and a
    fresh FCN of it drawn from seed 0."""
    from tpufusion.serve.replay import ReplayHarness as JaxReplayHarness

    harness = ReplayHarness(chunk=1, device="cpu")
    assert harness.cfg is DEFAULT and harness.chunk == 1
    want = FCN(DEFAULT.model, in_channels=3, seed=0).state_dict()
    assert all(torch.equal(harness.model.state_dict()[k], want[k]) for k in want)
    poses, founds, stats = harness.run(np.zeros((1, 64, 4), np.float32))
    assert poses.shape == (1, 7) and founds.shape == (1,) and stats.frames == 1
    assert JaxReplayHarness().chunk == ReplayHarness(device="cpu").chunk == 64


def test_replay_harness_rejects_bad_arguments():
    with pytest.raises(ValueError, match="host_ring"):
        ReplayHarness(_asset_cfg(), port_asset_model(), host_ring=1, device="cpu")
    harness = ReplayHarness(_asset_cfg(), port_asset_model(), device="cpu")
    with pytest.raises(ValueError, match="at least one frame"):
        harness.run(np.zeros((0, 128, 4), np.float32))


def test_latency_stats_matches_the_reference():
    from tpufusion.serve.replay import LatencyStats as JaxLatencyStats

    secs = [0.05, 0.02, 0.04, 0.08, 0.03]
    got, want = LatencyStats(secs, 4), JaxLatencyStats(secs, 4)
    assert got.summary() == want.summary()
    assert got.frames == want.frames == 20
    assert got.percentile_ms(90) == want.percentile_ms(90)


# -- an explicit device, the card by default ---------------------------------

def _tiny_fusion_data():
    return build_fusion_dataset(1, seed=2, n_points=2048, device="cpu")


def _call_predict_fusion(tmp_path, **kw):
    net = fusion_from_asset(FUSION_ASSET, "cpu", "float32")
    data = _tiny_fusion_data()
    out = str(tmp_path / "fusion.csv")
    predict_fusion(net, data, data["timestamps"].tolist(), out, batch_size=1, **kw)
    return open(out).read().count("\n")


_POINTS = np.zeros((1, 2048, 4), np.float32)
_SMALL = dict(n_points=2048, n_sets=1, reps=1)

_SMALL_SPEC = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
_TRAIN_CFG = DEFAULT.replace(range_view=_SMALL_SPEC, train=TrainConfig(batch_size=2, augment=False))


def _scene():
    p, gt, v = synthesize_beam_scan_batch(np.random.default_rng(3), 2, 2048)
    return {"points": p, "valid": v, **gt}


def _call_train_step(tmp_path, make=make_train_step, **kw):
    model = FCN(DEFAULT.model, seed=0)
    if make is make_eval_step:
        return make(_SMALL_SPEC, LossConfig(), **kw)(model, _scene())[0]
    step = make(_SMALL_SPEC, LossConfig(), _TRAIN_CFG.train, **kw)
    return step(model, Adam(model.parameters()), _scene())[0]


def _call_restore(tmp_path, **kw):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(7, FCN(DEFAULT.model, seed=0))
    model = FCN(DEFAULT.model)
    assert mgr.restore(model, **kw) == 7
    return model


def _call_train_fusion(tmp_path, **kw):
    net = fusion_from_asset(FUSION_ASSET, "cpu", "float32")
    data = build_fusion_dataset(2, seed=2, n_points=2048, device="cpu")
    return train_fusion(net, data, epochs=1, batch_size=2, **kw)


def _call_codec(fn):
    """The codecs work where their image lies: the image is made on the
    device asked for, the card by default."""
    def call(tmp_path, device="cuda"):
        scene = _scene()
        image = torch.zeros(2, 32, 201, 3, device=device)
        return fn(scene["center"], scene["size"], scene["yaw"], image, _SMALL_SPEC)
    return call


def _tool(main, *argv):
    """A tool's `main(argv)`, with `--device` where the caller gives one."""
    def call(tmp, **kw):
        device = ["--device", kw["device"]] if kw else []
        return main([a.format(tmp=tmp) for a in argv] + device)
    return call


def _call_tuner(tmp, **kw):
    import shutil

    for ext in ("", ".json"):
        shutil.copyfile(ASSET + ext, str(tmp / "det.npz") + ext)
    return _tool(tools_tuner.main, "--asset", "{tmp}/det.npz", "--batch", "1", "--n_points",
                 "1024", "--eval_batches", "1")(tmp, **kw)


_QUICK = dict(n_batches=1, steps_per_batch=1, batch=2)

ENTRY_POINTS = {
    "Trainer": lambda tmp, **kw: Trainer(_TRAIN_CFG, outdir=str(tmp / "run"), **kw).model,
    "make_train_step": _call_train_step,
    "make_eval_step": lambda tmp, **kw: _call_train_step(tmp, make_eval_step, **kw),
    "train_fusion": _call_train_fusion,
    "CheckpointManager.restore": _call_restore,
    "BatchPipeline": lambda tmp, **kw: next(iter(BatchPipeline(_scene(), 2, **kw)))["points"],
    "BatchPipeline(streaming)": lambda tmp, **kw: next(iter(BatchPipeline(
        _scene(), 2, device_resident=False, **kw)))["points"],
    "population_weights": lambda tmp, **kw: population_weights(
        _scene()["center"], _scene()["size"], _scene()["yaw"], _SMALL_SPEC, **kw),
    "encode_label_batch": _call_codec(encoding.encode_label_batch),
    "encode_direct_label_batch": _call_codec(encoding.encode_direct_label_batch),
    "pixel_angles": lambda tmp, **kw: encoding.pixel_angles(_SMALL_SPEC, **kw),
    "pixel_rotations": lambda tmp, **kw: encoding.pixel_rotations(_SMALL_SPEC, **kw),
    "config4_full_eval": lambda tmp, **kw: benchmarks.config4_full_eval(
        frames=2, batch=2, n_points=2048, reps=1, **kw),
    "config4_full_eval(quick_train)": lambda tmp, **kw: benchmarks.config4_full_eval(
        weights="quick_train", frames=2, batch=2, n_points=2048, reps=1, quick_train=_QUICK, **kw),
    "quick_trained_model": lambda tmp, **kw: benchmarks.quick_trained_model(
        n_points=2048, **_QUICK, **kw)[0],
    "make_e2e_step": lambda tmp, **kw: make_e2e_step(
        port_asset_model(), DEFAULT.range_view, asset_configs()[1], head="direct", **kw)(_POINTS),
    "predict_images": lambda tmp, **kw: predict_images(
        port_asset_model(), np.zeros((1, 32, 1801, 3), np.float32), _asset_cfg(), 1, **kw),
    "LidarPipeline": lambda tmp, **kw: LidarPipeline(
        cfg=_asset_cfg(), model=port_asset_model(), max_points=2048, **kw).predict_position(_POINTS[0]),
    "LidarPipeline.from_asset": lambda tmp, **kw: LidarPipeline.from_asset(
        ASSET, max_points=2048, **kw).predict_position(_POINTS[0]),
    "fcn_from_arrays": lambda tmp, **kw: fcn_from_arrays(
        load_npz(ASSET), asset_configs()[0], **kw),
    "fusion_from_asset": lambda tmp, **kw: fusion_from_asset(FUSION_ASSET, **kw),
    "predict_fusion": _call_predict_fusion,
    "ReplayHarness": lambda tmp, **kw: ReplayHarness(
        _asset_cfg(), port_asset_model(), chunk=1, host_ring=2, **kw).run(_POINTS),
    "build_fusion_dataset": lambda tmp, **kw: build_fusion_dataset(
        1, seed=2, n_points=2048, **kw),
    "config1_single_frame": lambda tmp, **kw: benchmarks.config1_single_frame(**_SMALL, **kw),
    "config2_replay": lambda tmp, **kw: benchmarks.config2_replay(batch=1, **_SMALL, **kw),
    "config3_fused": lambda tmp, **kw: benchmarks.config3_fused(batch=1, **_SMALL, **kw),
    "config5_waymo_scale": lambda tmp, **kw: benchmarks.config5_waymo_scale(
        batch=1, n_points=2048, n_beams=32, n_sets=1, reps=1, track_frames=2, track_points=2048,
        **kw),
    "make_mesh": lambda tmp, **kw: _call_make_mesh(**kw),
    "dryrun_multichip": lambda tmp, **kw: dryrun.dryrun_multichip(
        1, n_points=64, full_points=256, timeout=120, **kw),
    "spawn": lambda tmp, **kw: _call_spawn(tmp, **kw),
    "load_reference_fcn": lambda tmp, **kw: _call_load_reference_fcn(tmp, **kw),
    "extract_dataset": lambda tmp, **kw: extract_dataset(
        str(tmp / "ds"), _scene()["points"], np.array([1, 2]), **kw),
    "extract_bag_dataset": lambda tmp, **kw: extract_bag_dataset(
        _small_bag(tmp), str(tmp / "bag_ds"), **kw),
    "predict_dataset_dir": lambda tmp, **kw: _call_predict_dataset_dir(tmp, **kw),
    "cli.main": lambda tmp, **kw: _call_cli(tmp, **kw),
    "cli.main(view)": lambda tmp, **kw: _call_view_dataset(tmp, cli_view=True, **kw),
    "view_dataset": lambda tmp, **kw: _call_view_dataset(tmp, **kw),
    "tools.train_synthetic_detector": _tool(
        tools_trainer.main, "--steps", "2", "--batch", "1", "--n_points", "1024",
        "--eval_batches", "1", "--out", "{tmp}/det.npz"),
    "tools.tune_detector_asset": _call_tuner,
    "tools.detector_envelope": _tool(tools_envelope.main, "--batch", "4", "--eval_batches", "1"),
    "tools.fit_oracle_sensitivity": _tool(tools_oracle.main, "--batch", "2", "--eval_batches", "1"),
    "tools.train_fusion_synthetic": _tool(
        tools_fusion.main, "--train_frames", "2", "--eval_frames", "2", "--epochs", "1",
        "--batch", "2", "--out", "{tmp}/fusion.npz", "--cache_dir", "{tmp}/cache"),
    "tools.bench_camera_full": _tool(
        tools_camera.main, "--frames", "2", "--batch", "1", "--steps", "1",
        "--timing_batches", "1"),
}


def _small_bag(tmp) -> str:
    from tpufusion_torch.data.rosbag_reader import BagWriter, serialize_pointcloud2

    path = str(tmp / "small.bag")
    w = BagWriter(compression="lz4")
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    for i in range(2):
        w.add_message(0, 1_000 + i, serialize_pointcloud2(_scene()["points"][i, : 500 + 100 * i]))
    w.write(path)
    return path


def _call_predict_dataset_dir(tmp, **kw):
    ds = tmp / "stored"
    ds.mkdir(exist_ok=True)
    np.savez(ds / "lidar_frames.npz", images=np.zeros((2, 32, 1801, 3), np.float32),
             timestamps=np.array([5, 6]))
    return predict_dataset_dir(port_asset_model(), str(ds), str(tmp / "pred"), _asset_cfg(), 1, **kw)


def _call_cli(tmp, **kw):
    """`extract` of a points NPZ; the card unless `--device cpu` is given."""
    np.savez(tmp / "raw.npz", points=_scene()["points"], timestamps=np.array([1, 2]))
    device = ["--device", kw["device"]] if kw else []
    cli.main(["extract", str(tmp / "raw.npz"), str(tmp / "cli_ds"), *device])
    return load_extracted(str(tmp / "cli_ds"))["images"]


def _call_view_dataset(tmp, cli_view=False, **kw):
    """`view_dataset` (or `cli view`) of a points NPZ, one pass at a fast
    rate on an ephemeral port; returns the path it replayed."""
    from tpufusion_torch.serve.viewer import view_dataset

    path = str(tmp / "view.npz")
    np.savez(path, points=_scene()["points"])
    if cli_view:
        device = ["--device", kw["device"]] if kw else []
        cli.main(["view", path, "--port", "0", "--rate", "1000", *device])
    else:
        view_dataset(path, port=0, rate_hz=1000.0, **kw)
    return path


def _call_load_reference_fcn(tmp, **kw):
    from tests.torch_golden import write_shipped_h5

    path = str(tmp / "lidar_model.h5")
    write_shipped_h5(path, (32, 201), seed=0)
    return load_reference_fcn(path, (32, 201), **kw)


def _call_spawn(tmp, **kw):
    """One spawned rank; returns the tensor it made on its device."""
    from tests.test_torch_parallel import save_rank_probe

    path = str(tmp / "rank0.pt")
    dryrun.spawn(save_rank_probe, 1, args=(path,), timeout=120, **kw)
    return torch.load(path)


def _call_make_mesh(**kw):
    """A mesh of one (a group of one on a free port), this rank's rows."""
    mesh = make_mesh(MeshConfig(n_devices=1), **kw)
    try:
        return shard_batch({"x": np.zeros((2, 3), np.float32)}, mesh)["x"]
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_card_unless_asked_for_the_cpu(name, tmp_path):
    """Without `device` an entry point goes to the card, and where there
    is none it raises rather than carry on on the CPU; with device="cpu"
    it runs."""
    call = ENTRY_POINTS[name]
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda|nvidia"):
            call(tmp_path)
    out = call(tmp_path, device="cpu")
    assert out is not None
    for t in (out if isinstance(out, tuple) else (out,)):
        if isinstance(t, torch.Tensor):
            assert t.device.type == "cpu"
        if isinstance(t, torch.nn.Module):
            assert next(t.parameters()).device.type == "cpu"
    if name.startswith("config"):
        assert out["device"] == "cpu" and out["timer"] == "host clock"
        json.dumps(out)


def test_benchmarks_main_prints_one_json_line_per_config(capsys, monkeypatch):
    monkeypatch.setitem(benchmarks.CONFIGS, 1,
                        lambda device: benchmarks.config1_single_frame(device, **_SMALL))
    benchmarks.main(["--configs", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["config"] == 1 and row["unit"] == "ms/frame"
