"""The float16 configuration against the float16 golden
(`tests/data/torch_port_golden_f16.npz`), the checks the card makes of it
in chip_smoke.py phases 6 and 1e, here on the CPU: the shipped asset's
float16 FCN against JAX's float16 FCN sample (F16_PROB_ATOL, F16_REG_ATOL
and F16_REG_DIFFER_SHARE of tpufusion_torch/_golden.py), with the faults
it must catch; the float16 main path (`make_e2e_step`, head "direct",
top-4) against JAX's poses; and the golden's currency against JAX run
here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_multi import _one_rounding_forward
from tests.torch_golden import (
    ASSET,
    GOLDEN_F16,
    GOLDEN_MULTI,
    asset_configs,
    jax_asset_model,
    jax_forward,
    jax_step,
    load_npz,
    port_asset_model,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion_torch._golden import (
    F16_E2E_K,
    F16_PROB_ATOL,
    F16_REG_ATOL,
    F16_REG_DIFFER_SHARE,
    fcn_golden_sample,
    fcn_sample_readings,
    from_f16_bits,
)
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models import fcn
from tpufusion_torch.predict import make_e2e_step

SPEC = RangeViewSpec()
POSE_TOL = 1e-4  # the float16 main path against JAX's (reads 3.8e-6 here)


@pytest.fixture(scope="module")
def golden():
    return load_npz(GOLDEN_F16)


@pytest.fixture(scope="module")
def frames():
    """The multi golden's three two-vehicle frames: (points, valid)."""
    gm = load_npz(GOLDEN_MULTI)
    return gm["multi_points"], gm["multi_valid"]


def _port_fcn_output(frames, dtype="float16") -> np.ndarray:
    points, valid = frames
    images = range_view_project_batch(torch.from_numpy(points), SPEC, torch.from_numpy(valid))
    with torch.inference_mode():
        return port_asset_model(ASSET, dtype)(images).numpy()


@pytest.mark.parametrize("fault", ["none", "once", "float32"])
def test_f16_fcn_against_the_golden_sample(golden, frames, monkeypatch, fault):
    """The check chip_smoke phase 6 makes of the card's float16 FCN: the
    golden's sample of JAX's float16 output, probabilities within
    F16_PROB_ATOL, regression within F16_REG_ATOL and at most
    F16_REG_DIFFER_SHARE of its outputs off at all. The port passes it
    (reads 1.5e-4, 2**-8 and 1.1 % here); rounding each convolution once
    instead of twice (a fused bias epilogue; 49 % differ) fails it, and so
    does the float32 net (100 %)."""
    dtype = "float32" if fault == "float32" else "float16"
    if fault == "once":
        monkeypatch.setattr(fcn.Conv, "forward", lambda m, x: _one_rounding_forward(m, x, False))
        monkeypatch.setattr(
            fcn.ConvTranspose, "forward", lambda m, x: _one_rounding_forward(m, x, True)
        )
    out = _port_fcn_output(frames, dtype)
    dp, dr, n_diff, n = fcn_sample_readings(out, golden["fcn_prob"],
                                            from_f16_bits(golden["fcn_reg_bits"]))
    passes = dp <= F16_PROB_ATOL and dr <= F16_REG_ATOL and n_diff <= F16_REG_DIFFER_SHARE * n
    assert passes == (fault == "none"), (dp, dr, n_diff, n)


def test_f16_e2e_step_matches_the_golden(golden, frames):
    """The float16 main path: make_e2e_step(head="direct", top-4) with the
    shipped asset in float16 against JAX's on the same frames (found
    equal, poses within POSE_TOL, yaw as an angle), and k=1 as its first
    lane; it finds what the float32 path finds. The FCN's output is
    float32, so the decode runs the kernel's float32 instance."""
    points, valid = frames
    _, dcfg = asset_configs()
    model = port_asset_model(ASSET, "float16")
    poses, found = make_e2e_step(model, SPEC, dcfg, max_obstacles=F16_E2E_K, head="direct",
                                 device="cpu")(points, valid)
    assert poses.dtype == torch.float32 and poses.shape == (3, F16_E2E_K, 7)
    np.testing.assert_array_equal(found.numpy(), golden["e2e_found"])
    assert golden["e2e_found"][:, :2].all()
    assert float(wrapped_pose_diff(poses.numpy(), golden["e2e_poses"]).max()) <= POSE_TOL
    poses1, found1 = make_e2e_step(model, SPEC, dcfg, head="direct", device="cpu")(points, valid)
    np.testing.assert_array_equal(found1.numpy(), golden["e2e_found"][:, 0])
    assert float(wrapped_pose_diff(poses1.numpy(), golden["e2e_poses"][:, 0]).max()) <= POSE_TOL
    f32 = make_e2e_step(port_asset_model(ASSET), SPEC, dcfg, max_obstacles=F16_E2E_K,
                        head="direct", device="cpu")(points, valid)[1]
    assert torch.equal(f32, found)


def test_golden_f16_file_is_current(golden, frames):
    """The golden's FCN sample and main-path poses equal what the JAX
    package computes now (rerun `tests/make_torch_port_golden.py f16` if
    not): the sample within float16 noise of XLA on another CPU (one
    regression step, F16_PROB_ATOL), the poses within 1e-6."""
    points, valid = frames
    images = np.asarray(jax_project(jnp.asarray(points), to_jax_config(SPEC),
                                    jnp.asarray(valid)))
    prob, reg = fcn_golden_sample(jax_forward(jax_asset_model(dtype="float16"), images))
    np.testing.assert_allclose(golden["fcn_prob"], prob, rtol=0, atol=F16_PROB_ATOL)
    np.testing.assert_allclose(from_f16_bits(golden["fcn_reg_bits"]), reg, rtol=0,
                               atol=F16_REG_ATOL)
    poses, found = jax_step(jax_asset_model(dtype="float16"), asset_configs()[1], points, valid,
                            k=F16_E2E_K)
    np.testing.assert_array_equal(golden["e2e_found"], found)
    np.testing.assert_allclose(golden["e2e_poses"], poses, rtol=0, atol=1e-6)


def test_f16_model_serves_through_the_pipeline_replay_and_config1(golden, frames):
    """serve/pipeline.py, serve/replay.py and benchmarks.py take a float16
    model as they are: LidarPipeline.predict_position answers JAX's
    float16 main path (the golden's first lane), ReplayHarness.run (chunk
    2, a padded chunk) answers what make_e2e_step answers on the same
    clouds, and config 1's step returns the FCN's float32 output."""
    from tpufusion_torch import benchmarks
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.serve.pipeline import LidarPipeline
    from tpufusion_torch.serve.replay import ReplayHarness

    points, valid = frames
    _, dcfg = asset_configs()
    model = port_asset_model(ASSET, "float16")
    cfg = DEFAULT.replace(model=model.cfg, decode=dcfg)
    pipe = LidarPipeline(cfg=cfg, model=model, max_points=points.shape[1], device="cpu")
    got = [pipe.predict_position(p[v]) for p, v in zip(points, valid)]
    np.testing.assert_array_equal([f for _, f in got], golden["e2e_found"][:, 0])
    diff = wrapped_pose_diff(np.stack([p for p, _ in got]), golden["e2e_poses"][:, 0])
    assert float(diff.max()) <= POSE_TOL
    clouds = np.where(valid[..., None], points, np.nan).astype(np.float32)
    want_p, want_f = make_e2e_step(model, SPEC, dcfg, head="direct", device="cpu")(clouds)
    poses, found, _ = ReplayHarness(cfg, model, chunk=2, device="cpu").run(clouds)
    np.testing.assert_array_equal(found, want_f.numpy())
    assert found.all() and float(wrapped_pose_diff(poses, want_p.numpy()).max()) <= 1e-5
    pts, ok = torch.from_numpy(points), torch.from_numpy(valid)
    out, _ = benchmarks.make_config1_step(model, "cpu")(pts, ok)
    with torch.inference_mode():
        want = model(range_view_project_batch(pts, SPEC, ok))
    assert out.dtype == torch.float32 and torch.equal(out, want)
