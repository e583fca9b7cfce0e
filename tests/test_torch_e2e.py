"""Golden tests: the port's main path end to end against JAX, with the
shipped detector asset on beam-scan frames at full width.

Tolerances: `found` exactly; poses within POSE_ATOL (1e-4,
tests/torch_golden.py); range-view images bit-identical.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.make_torch_port_golden import golden_arrays
from tests.torch_golden import (
    ASSET,
    GOLDEN,
    POSE_ATOL,
    REPO,
    asset_configs,
    image_digest,
    jax_beam_scans,
    jax_e2e,
)
from tpufusion_torch import RangeViewSpec
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline


@pytest.fixture(scope="module")
def scans():
    """4 x 32,768 JAX beam scans and the JAX main path's answer on them."""
    points, valid = jax_beam_scans(0, 4)
    poses, found, _ = jax_e2e(points, valid)
    return points, valid, poses, found


@pytest.fixture(scope="module")
def pipeline():
    return LidarPipeline.from_asset(ASSET, "cpu")


def _step(pipeline):
    return make_e2e_step(
        pipeline.model, pipeline.cfg.range_view, pipeline.cfg.decode
    )


def test_e2e_step_matches_jax(scans, pipeline):
    points, valid, want_poses, want_found = scans
    poses, found = _step(pipeline)(points, valid)
    assert poses.shape == (4, 7) and found.shape == (4,)
    np.testing.assert_array_equal(found.numpy(), want_found)
    assert want_found.all()
    np.testing.assert_allclose(poses.numpy(), want_poses, rtol=0, atol=POSE_ATOL)


def test_pipeline_predict_position_matches_jax(scans, pipeline):
    """The server pads each request to max_points as the JAX facade does;
    a request carries the valid returns only."""
    points, valid, want_poses, want_found = scans
    for b in range(len(points)):
        pose, found = pipeline.predict_position(points[b][valid[b]])
        assert pose.shape == (7,) and found == bool(want_found[b])
        np.testing.assert_allclose(pose, want_poses[b], rtol=0, atol=POSE_ATOL)


def test_pipeline_uses_the_asset_operating_point(pipeline):
    mcfg, dcfg = asset_configs()
    assert pipeline.cfg.model == mcfg and pipeline.cfg.decode == dcfg
    assert pipeline.cfg.model.head == "direct" and pipeline.max_points == 65536


def test_golden_file_is_current():
    """tests/data/torch_port_golden.npz equals what the JAX package
    computes now (rerun tests/make_torch_port_golden.py if not)."""
    want = golden_arrays()
    with np.load(GOLDEN) as z:
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            if k == "poses":
                np.testing.assert_allclose(z[k], v, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(z[k], v, err_msg=k)
    assert want["found"].all()


def test_port_matches_golden_on_cpu(pipeline):
    with np.load(GOLDEN) as z:
        points, valid = z["points"], z["valid"]
        found_want, poses_want, digests = z["found"], z["poses"], z["image_sha256"]
    poses, found = _step(pipeline)(points, valid)
    np.testing.assert_array_equal(found.numpy(), found_want)
    np.testing.assert_allclose(poses.numpy(), poses_want, rtol=0, atol=POSE_ATOL)
    images = range_view_project_batch(
        torch.from_numpy(points), RangeViewSpec(), torch.from_numpy(valid)
    ).numpy()
    assert [image_digest(im) for im in images] == list(digests)


def test_port_imports_no_jax():
    """The port, driven through its paths (the server, the bf16 top-4
    step, the tracker and scoring, the corner head, predict_images),
    never loads jax, flax or the JAX package."""
    code = textwrap.dedent(
        """
        import dataclasses, sys
        import numpy as np
        import torch
        torch.set_num_threads(2)  # beside the test workers
        from tpufusion_torch.config import DEFAULT
        from tpufusion_torch.data.synthetic import (
            synthesize_beam_scan_batch, synthesize_beam_tracking_sequence)
        from tpufusion_torch.models.fcn import FCN
        from tpufusion_torch.models.io import asset_configs, load_state_npz
        from tpufusion_torch.predict import make_e2e_step, predict_images
        from tpufusion_torch.serve.pipeline import LidarPipeline
        from tpufusion_torch.serve.tracker import PoseTracker, track_quality_metrics
        from tpufusion_torch.eval.scoring import score_multi_poses
        from tpufusion_torch import DecodeConfig, ModelConfig, RangeViewSpec
        pipe = LidarPipeline.from_asset(sys.argv[1], "cpu")
        points, _, valid = synthesize_beam_scan_batch(np.random.default_rng(0), 1)
        pose, found = pipe.predict_position(points[0][valid[0]])
        assert pipe.fake_predict(points[0][valid[0]]).shape == (3,)
        mcfg, dcfg = asset_configs(sys.argv[1])
        model = FCN(dataclasses.replace(mcfg, dtype="bfloat16"))
        load_state_npz(sys.argv[1], model)
        seq, gt, sv = synthesize_beam_tracking_sequence(np.random.default_rng(1), 3)
        poses, founds = make_e2e_step(model, RangeViewSpec(), dcfg, max_obstacles=4)(seq, sv)
        trails = PoseTracker(dt=0.1).run_multi(poses.numpy(), founds.numpy())
        track_quality_metrics(trails, gt["center"])
        score_multi_poses(poses.numpy(), founds.numpy(), gt["center"], gt["yaw"], gt["size"])
        corner = FCN(ModelConfig())
        corner.deconv6a.bias.data = torch.tensor([2.0, -2.0])  # background-leaning
        make_e2e_step(corner, RangeViewSpec(), DecodeConfig(), head="corner",
                      max_obstacles=2)(seq[:1], sv[:1])
        images = np.zeros((1, 32, 1801, 3), np.float32)
        predict_images(corner, images, DEFAULT, 1)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "tpufusion"))
        assert not loaded, loaded
        print("NO_JAX_OK", found)
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code, ASSET], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "NO_JAX_OK" in out.stdout


def test_numpy_beam_scans_feed_the_detector(pipeline):
    """The numpy generator (the card's request source) draws scenes the
    asset detects: same distribution as the JAX generator."""
    points, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(5), 4)
    assert points.shape == (4, 32768, 4) and points.dtype == np.float32
    assert valid.shape == (4, 32768) and 0.4 < valid.mean() < 0.9
    assert (points[~valid] == 0).all()
    poses, found = _step(pipeline)(points, valid)
    assert found.all()
    xy_err = np.linalg.norm(poses[:, :2].numpy() - gt["center"][:, :2], axis=1)
    assert xy_err.max() < 2.0, xy_err
    with pytest.raises(NotImplementedError):
        synthesize_beam_scan_batch(np.random.default_rng(0), 1, vehicle_surface="box")


def test_e2e_step_rejects_unknown_head_and_k(pipeline):
    spec, dcfg = pipeline.cfg.range_view, pipeline.cfg.decode
    with pytest.raises(ValueError, match="head"):
        make_e2e_step(pipeline.model, spec, dcfg, head="box")
    with pytest.raises(ValueError, match="max_obstacles"):
        make_e2e_step(pipeline.model, spec, dcfg, max_obstacles=0)


def test_pipeline_fake_predict_is_the_cloud_mean():
    points = np.random.default_rng(0).normal(size=(100, 4)).astype(np.float32)
    np.testing.assert_allclose(
        LidarPipeline.fake_predict(points), points[:, :3].astype(np.float64).mean(axis=0)
    )


def test_from_asset_raises_on_a_mismatched_asset(tmp_path):
    """No quick-training fallback: an asset whose json names another
    geometry than its weights raises."""
    bad = tmp_path / "detector.npz"
    bad.write_bytes(open(ASSET, "rb").read())
    (tmp_path / "detector.npz.json").write_text('{"model": {"head": "direct"}}')
    with pytest.raises(ValueError):
        LidarPipeline.from_asset(str(bad), "cpu")
