"""Config 5 and config 4's companion rows of the port's benchmarks, on the
CPU at reduced frame counts (the card runs the defaults: chip_smoke.py
phases 18 and 20), and the pieces they share with the reference.

The scenes come from numpy seeds, so the rows' scores are the port's own:
they are held to what the shipped assets reach on their scenes (every
vehicle found, boxes overlapping), not to the reference's numbers.
"""

import json

import numpy as np
import pytest

import tpufusion.benchmarks as jax_benchmarks
from tpufusion.tools import detector_envelope as jax_envelope
from tpufusion_torch import benchmarks
from tpufusion_torch.config import DecodeConfig
from tpufusion_torch.tools import detector_envelope

SMALL5 = dict(batch=1, n_points=4096, n_beams=32, n_sets=1, reps=1, track_frames=4)


@pytest.fixture(scope="module")
def config5_row():
    return benchmarks.config5_waymo_scale("cpu", **SMALL5)


def test_config5_tracks_both_vehicles(config5_row):
    """Four frames of the two-vehicle sequence at 32,768 points through the
    asset's top-4 decode and the tracker; a valid JSON row (no NaN)."""
    row = config5_row
    assert row["config"] == 5 and row["unit"] == "frames/s/chip" and row["device"] == "cpu"
    assert row["detections"] >= 6 and row["tracks"] >= 1
    assert row["box_recall"] >= 0.75 and row["box_mean_iou"] > 0.3
    json.dumps(row, allow_nan=False)


def test_config5_oriented_row_tracks_in_the_physical_frame(config5_row):
    """The wide-yaw asset on ellipse vehicles heading along their velocity."""
    row = config5_row["oriented"]
    assert row["asset"] == "synthetic_detector_yaw.npz"
    assert row["box_recall"] >= 0.5 and row["tracks"] >= 1
    assert set(row) >= {"vehicles_tracked", "spurious_tracks", "id_switches", "fragmentation",
                        "track_coverage", "box_mean_iou", "box_yaw_err"}


def test_config4_carries_the_companion_rows():
    """wide_yaw (its json's scenes: ellipse, max_yaw 0.45) and mixed_family
    (circle, ellipse, box) at 4 frames a family."""
    row = benchmarks.config4_full_eval("cpu", frames=4, batch=4, n_points=4096, reps=1,
                                       companion_frames=4)
    wide, mixed = row["wide_yaw"], row["mixed_family"]
    assert wide["asset"] == "synthetic_detector_yaw.npz" and wide["scenes"] == "beam-ellipse"
    assert wide["max_yaw"] == 0.45 and wide["detection_rate"] >= 0.75
    assert mixed["asset"] == "synthetic_detector_mixed.npz"
    assert sorted(mixed["per_family"]) == ["beam", "beam-box", "beam-ellipse"]
    for fam in mixed["per_family"].values():
        assert fam["detection_rate"] >= 0.75 and fam["mean_iou"] > 0.1
    ious = [f["mean_iou"] for f in mixed["per_family"].values()]
    assert mixed["cross_family_mean_iou"] == round(float(np.mean(ious)), 3)
    json.dumps(row, allow_nan=False)


def test_config4_leaves_the_companion_rows_out_when_asked():
    """companion_frames=0: the row without wide_yaw and mixed_family (they
    use the shipped assets whatever the weights, so a second run of
    config 4 need not repeat them)."""
    row = benchmarks.config4_full_eval("cpu", frames=2, batch=2, n_points=2048, reps=1,
                                       companion_frames=0)
    assert "wide_yaw" not in row and "mixed_family" not in row
    assert row["config"] == 4 and row["weights"] == "asset"
    json.dumps(row, allow_nan=False)


def test_companion_rows_raise_without_their_asset(monkeypatch, tmp_path):
    """The reference drops a companion row on any fault; the port raises."""
    monkeypatch.setattr(benchmarks, "detector_asset_path", lambda name="": str(tmp_path / name))
    with pytest.raises(FileNotFoundError):
        benchmarks.wide_yaw_eval("cpu", frames=1, batch=1)
    with pytest.raises(FileNotFoundError):
        benchmarks.oriented_tracking_eval("cpu", frames=1)


def test_main_runs_config5(capsys, monkeypatch):
    monkeypatch.setitem(benchmarks.CONFIGS, 5, lambda device: benchmarks.config5_waymo_scale(
        device, **dict(SMALL5, track_frames=2, track_points=2048)))
    benchmarks.main(["--configs", "5", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["config"] == 5


META_CASES = [
    {}, {"scenes": "beam-ellipse", "max_yaw": 0.45, "n_points": 16384},
    {"scenes": "beam-box"}, {"scenes": "mixed", "max_yaw": 0.45}, {"scenes": "beam", "max_yaw": 0.3},
]


@pytest.mark.parametrize("meta", META_CASES)
def test_base_condition_copy_matches(meta):
    assert detector_envelope.base_condition_from_meta(meta) == jax_envelope.base_condition_from_meta(meta)


@pytest.mark.parametrize("n_points", [4096, 16384, 20000, 32768, 100_000])
def test_decode_for_resolution_matches(n_points):
    import tpufusion.config as jax_config

    meta = {"decode_per_resolution": {"16384": {"min_prob": 0.3}, "32768": {"min_prob": 0.8,
                                                                           "min_bbox_area": 20.0}}}
    got = benchmarks.decode_for_resolution(DecodeConfig(), meta, n_points)
    want = jax_benchmarks.decode_for_resolution(jax_config.DecodeConfig(), meta, n_points)
    assert (got.min_prob, got.min_bbox_area) == (want.min_prob, want.min_bbox_area)
    base = DecodeConfig()
    assert benchmarks.decode_for_resolution(base, {}, n_points) is base
    assert benchmarks.decode_for_resolution(base, None, n_points) is base
