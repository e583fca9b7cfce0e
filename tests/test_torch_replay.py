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
from tpufusion_torch import benchmarks
from tpufusion_torch.config import DEFAULT
from tpufusion_torch.data.synthetic import build_fusion_dataset, synthesize_beam_scan_batch
from tpufusion_torch.models.io import fcn_from_arrays, fusion_from_asset
from tpufusion_torch.predict import make_e2e_step, predict_images
from tpufusion_torch.serve.fusion import predict_fusion
from tpufusion_torch.serve.pipeline import LidarPipeline
from tpufusion_torch.serve.replay import LatencyStats, ReplayHarness


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

ENTRY_POINTS = {
    "make_e2e_step": lambda tmp, **kw: make_e2e_step(
        port_asset_model(), DEFAULT.range_view, asset_configs()[1], **kw)(_POINTS),
    "predict_images": lambda tmp, **kw: predict_images(
        port_asset_model(), np.zeros((1, 32, 1801, 3), np.float32), _asset_cfg(), 1, **kw),
    "LidarPipeline": lambda tmp, **kw: LidarPipeline(
        port_asset_model(), _asset_cfg(), 2048, **kw).predict_position(_POINTS[0]),
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
}


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
