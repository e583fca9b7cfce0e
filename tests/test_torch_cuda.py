"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), is
marked `cuda`, and skips where there is none. The file imports no JAX, so
it runs on a machine with the card but without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax; the file imports nothing
from the tests directory either, whose name another installed package may
shadow.) Tolerance: none — both kernels compute exact integer answers;
1e-3 on the main path's poses against the JAX golden (CUDA's atan2f /
sinf / cosf differ by ulps from the CPU's).
"""

import os

import numpy as np
import pytest
import torch

from tpufusion_torch import RangeViewSpec
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.geometry.range_view import _frame_pixels_keys
from tpufusion_torch.ops import cc, components, projection
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline

pytestmark = pytest.mark.cuda
SPEC = RangeViewSpec()
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_port_golden.npz")


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off; skips the test where there is none
    (decided inside the test, so every xdist worker collects the same
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _proj_inputs(device, batch=4, n=8192, seed=3):
    rng = np.random.default_rng(seed)
    pts = (rng.standard_normal((batch, n, 4)) * 20).astype(np.float32)
    pts[:, n // 2 : n // 2 + 512] = pts[:, :512]  # exact-key ties
    pts[0, 5] = np.nan
    valid = rng.random((batch, n)) > 0.1
    return _frame_pixels_keys(
        torch.from_numpy(pts).to(device), SPEC, torch.from_numpy(valid).to(device)
    )


def test_projection_kernel_is_bit_identical(cuda_device):
    for batch, n in ((4, 8192), (64, 32768), (3, 4097)):
        args = _proj_inputs(cuda_device, batch, n)
        before = projection.LAUNCHES
        got = projection.nearest_wins_image(*args, SPEC)
        want = projection.nearest_wins_image_reference(*args, SPEC)
        torch.cuda.synchronize()
        assert projection.LAUNCHES == before + 1
        assert torch.equal(got, want)


def test_projection_kernel_rejects_bad_inputs(cuda_device):
    pix, key, ok, payload = _proj_inputs(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        projection.nearest_wins_image(pix.long(), key, ok, payload, SPEC)
    with pytest.raises(ValueError, match="contiguous"):
        projection.nearest_wins_image(
            pix, key, ok, payload.transpose(0, 1).contiguous().transpose(0, 1), SPEC
        )
    with pytest.raises(ValueError, match="CUDA"):
        projection.nearest_wins_image(pix, key.cpu(), ok, payload, SPEC)


def test_cc_kernel_matches_twin(cuda_device):
    rng = np.random.default_rng(7)
    masks = []
    for density in (0.0, 0.05, 0.4, 0.6):
        m = rng.random((32, 1801)) < density
        m[10:20, 1700:] = True
        m[10:20, :100] = True
        masks.append(m)
    mask = torch.from_numpy(np.stack(masks)).to(cuda_device)
    before = cc.LAUNCHES
    got = cc.connected_components_with_bbox(mask, 128, "auto")
    _, sweeps = components.propagate(components.init_state(mask), mask, 4096)
    want = components.connected_components_with_bbox(mask, 4096)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
    assert int(sweeps.max()) < 4096  # the twin converged everywhere
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cc_kernel_rejects_bad_inputs(cuda_device):
    mask = torch.zeros((2, 32, 181), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="bool"):
        cc.connected_components_with_bbox(mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        cc.connected_components_with_bbox(mask.transpose(1, 2))
    with pytest.raises(ValueError, match="impl"):
        cc.connected_components_with_bbox(mask, 128, "scan")


def test_main_path_runs_both_kernels_and_matches_golden(cuda_device):
    pipe = LidarPipeline.from_asset(ASSET, cuda_device)
    step = make_e2e_step(pipe.model, pipe.cfg.range_view, pipe.cfg.decode)
    points, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(1), 8)
    p0, c0 = projection.LAUNCHES, cc.LAUNCHES
    poses, found = step(points, valid)
    torch.cuda.synchronize()
    assert projection.LAUNCHES > p0 and cc.LAUNCHES > c0
    assert poses.is_cuda and torch.isfinite(poses).all() and found.all()
    with np.load(GOLDEN) as z:
        poses, found = step(z["points"], z["valid"])
        np.testing.assert_array_equal(found.cpu().numpy(), z["found"])
        diff = poses.cpu().numpy() - z["poses"]
        diff[:, 3] = (diff[:, 3] + np.pi) % (2 * np.pi) - np.pi  # yaw is an angle
        assert np.abs(diff).max() < 1e-3

