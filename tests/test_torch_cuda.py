"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), is
marked `cuda`, and skips where there is none. The file imports no JAX, so
it runs on a machine with the card but without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax; the file imports nothing
from the tests directory either, whose name another installed package may
shadow.) The adversarial kernel inputs are
`tpufusion_torch/ops/parity_inputs.py`'s, which chip_smoke.py phases 2-3
run too. Tolerance: none — both kernels compute exact integer answers;
1e-3 on float32 poses against the JAX goldens (CUDA's atan2f / sinf /
cosf differ by ulps from the CPU's), poses from the bf16 FCN included
(they read 3.8e-6 on an H100); the bf16 FCN's own output within
tpufusion_torch/_golden.py's BF16_* limits of JAX's.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tpufusion_torch import DecodeConfig, RangeViewSpec
from tpufusion_torch._golden import (
    BF16_PROB_ATOL,
    BF16_REG_ATOL,
    BF16_REG_DIFFER_SHARE,
    bf16_fcn_readings,
    load_npz,
    wrapped_pose_diff,
)
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.decode import decode
from tpufusion_torch.geometry.range_view import _frame_pixels_keys, range_view_project_batch
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import asset_configs, load_state_npz
from tpufusion_torch.ops import cc, components, parity_inputs, projection
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline

pytestmark = pytest.mark.cuda
SPEC = RangeViewSpec()
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(_REPO, "tests", "data", "torch_port_golden_multi.npz")
POSE_TOL = 1e-3


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off (set again after the test); skips
    the test where there is none (decided inside the test, so every
    xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda", 0)
    torch.set_float32_matmul_precision("highest")


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
    for batch, n in ((4, 8192), (1, 32768), (8, 32768), (64, 32768), (16, 131072), (3, 4097)):
        args = _proj_inputs(cuda_device, batch, n)
        before = projection.LAUNCHES
        got = projection.nearest_wins_image(*args, SPEC)
        want = projection.nearest_wins_image_reference(*args, SPEC)
        torch.cuda.synchronize()
        assert projection.LAUNCHES == before + 1
        assert torch.equal(got, want)


@pytest.mark.parametrize(
    "batch,n,kinds", parity_inputs.ZBUFFER_SHAPES,
    ids=[f"{b}x{n}-{k[0] if len(k) == 1 else 'mixed'}"
         for b, n, k in parity_inputs.ZBUFFER_SHAPES],
)
def test_projection_kernel_adversarial_inputs(cuda_device, batch, n, kinds):
    """A whole frame in one pixel, exact-key ties, invalid points with
    garbage ids, an empty frame, points all in one cluster CTA's slice."""
    p = SPEC.height * SPEC.width
    args = [torch.from_numpy(a).to(cuda_device)
            for a in parity_inputs.zbuffer_args(batch, n, p, kinds=kinds)]
    got = projection.nearest_wins_image(*args, SPEC)
    want = projection.nearest_wins_image_reference(*args, SPEC)
    torch.cuda.synchronize()
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


@pytest.mark.parametrize("batch", parity_inputs.CC_BATCHES)
def test_cc_kernel_adversarial_masks(cuda_device, batch):
    """Full foreground, serpentines across every strip border, a comb and
    stripes on the border columns, a checkerboard, blobs at columns 0 and
    1800, the ragged last strip, frame b's last strip beside frame b+1's
    first; the plain sweeps run to convergence."""
    mask = torch.from_numpy(parity_inputs.cc_batch(batch)).to(cuda_device)
    got = cc.connected_components_with_bbox(mask)
    _, sweeps = components.propagate(components.init_state(mask), mask, 16384)
    want = components.connected_components_with_bbox(mask, 16384)
    torch.cuda.synchronize()
    assert int(sweeps.max()) < 16384  # the plain sweeps converged
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[mask], w[mask])
    big = components._BIG
    bg = ~mask
    assert (got[1][bg] == big).all() and (got[2][bg] == -big).all()
    assert (got[3][bg] == big).all() and (got[4][bg] == -big).all()


def test_cc_kernel_rejects_bad_inputs(cuda_device):
    mask = torch.zeros((2, 32, 181), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="bool"):
        cc.connected_components_with_bbox(mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        cc.connected_components_with_bbox(mask.transpose(1, 2))
    with pytest.raises(ValueError, match="impl"):
        cc.connected_components_with_bbox(mask, 128, "scan")
    with pytest.raises(ValueError, match="H <= 32"):  # a strip holds 32 rows
        cc.connected_components_with_bbox(torch.zeros((1, 33, 64), dtype=torch.bool,
                                                      device=cuda_device))


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
        assert _pose_diff(poses, z["poses"]) < POSE_TOL


def _pose_diff(got, want):
    return wrapped_pose_diff(got, want).max()


def test_bf16_top4_path_runs_in_bf16_and_matches_golden(cuda_device):
    """Config 5's path on the card: the asset's FCN in bf16 (its convs
    really return bf16) against the golden's sample of JAX's bf16 FCN
    output, and top-4 poses against JAX's bf16 answer."""
    g = load_npz(GOLDEN_MULTI)
    mcfg, dcfg = asset_configs(ASSET)
    model = FCN(dataclasses.replace(mcfg, dtype="bfloat16"))
    load_state_npz(ASSET, model)
    model = model.to(cuda_device).eval()
    dtypes = []
    model.conv1.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    p0, c0 = projection.LAUNCHES, cc.LAUNCHES
    poses, found = make_e2e_step(model, SPEC, dcfg, max_obstacles=4)(
        g["multi_points"], g["multi_valid"]
    )
    torch.cuda.synchronize()
    assert dtypes == [torch.bfloat16]
    assert projection.LAUNCHES > p0 and cc.LAUNCHES > c0
    np.testing.assert_array_equal(found.cpu().numpy(), g["direct_bf16_found"])
    assert _pose_diff(poses, g["direct_bf16_poses"]) < POSE_TOL
    with torch.inference_mode():
        out = model(range_view_project_batch(
            torch.from_numpy(g["multi_points"]).to(cuda_device), SPEC,
            torch.from_numpy(g["multi_valid"]).to(cuda_device),
        ))
    dp, dr, n_diff, n = bf16_fcn_readings(
        out.cpu().numpy(), g["bf16_fcn_prob"], g["bf16_fcn_reg"]
    )
    assert dp <= BF16_PROB_ATOL and dr <= BF16_REG_ATOL
    assert n_diff <= BF16_REG_DIFFER_SHARE * n


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_corner_decode_matches_golden(cuda_device, precision):
    """decode_batch, decode_batch_multi(k=4) and the 64-candidate
    overflow case on the label-encoded corner outputs, also with the
    process's float32 matmuls set to TF32 ("high"): the decode pins full
    float32 for its own matmuls and leaves the setting as it was."""
    g = load_npz(GOLDEN_MULTI)
    torch.set_float32_matmul_precision(precision)
    images = range_view_project_batch(
        torch.from_numpy(g["multi_points"][:2]).to(cuda_device), SPEC,
        torch.from_numpy(g["multi_valid"][:2]).to(cuda_device),
    )
    y = torch.from_numpy(g["corner_ypred"]).to(cuda_device)
    for case, cfg in (("corner", DecodeConfig()),
                      ("corner_k64", DecodeConfig(max_candidates=64))):
        out = decode.decode_batch(y, images, SPEC, cfg)
        np.testing.assert_array_equal(out["found"].cpu().numpy(), g[f"{case}_found"])
        np.testing.assert_array_equal(
            out["vote_overflow"].cpu().numpy(), g[f"{case}_overflow"]
        )
        assert _pose_diff(out["pose"], g[f"{case}_poses"]) < POSE_TOL
    out = decode.decode_batch_multi(y, images, SPEC, DecodeConfig(), 4)
    np.testing.assert_array_equal(out["found"].cpu().numpy(), g["corner_multi_found"])
    np.testing.assert_array_equal(
        out["vote_overflow"].cpu().numpy(), g["corner_multi_overflow"]
    )
    assert _pose_diff(out["poses"], g["corner_multi_poses"]) < POSE_TOL
    assert torch.get_float32_matmul_precision() == precision


def test_topk_order_with_ties_matches_the_cpu(cuda_device):
    """torch.topk on the card ranks the unique key as on the CPU: equal
    areas to the smaller root, padding entries when k exceeds the
    clusters."""
    prob = np.zeros((2, 32, 181), np.float32)
    for r0, c0 in ((4, 150), (4, 40), (18, 90), (18, 10)):
        prob[0, r0 : r0 + 8, c0 : c0 + 12] = 1.0
    prob[1, 12:18, 100:110] = 1.0
    cfg = DecodeConfig(min_bbox_area=8.0)
    for k in (1, 3, 6):
        got = decode.find_obstacles_topk(torch.from_numpy(prob).to(cuda_device), cfg, k)
        want = decode.find_obstacles_topk(torch.from_numpy(prob), cfg, k)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)


# -- BEV, the fusion net and the replay server's pinned ring -----------------

GOLDEN_FUSION = os.path.join(_REPO, "tests", "data", "torch_port_golden_fusion.npz")
FUSION_ASSET = os.path.join(_REPO, "tpufusion", "assets", "fusion_net.npz")


def test_bev_on_the_card_matches_the_cpu_and_jax(cuda_device):
    """Counts (the occupied cells) and both max channels bit-identical to
    the CPU's and to JAX's cells; the density within 1e-4 of 255."""
    from tpufusion_torch import _golden
    from tpufusion_torch.config import BevSpec
    from tpufusion_torch.geometry.bev import bev_rasterize_batch

    g = load_npz(GOLDEN_FUSION)
    pts, valid = torch.from_numpy(g["bev_points"]), torch.from_numpy(g["bev_valid"])
    got = bev_rasterize_batch(pts.to(cuda_device), BevSpec(), valid.to(cuda_device)).cpu().numpy()
    for want in (bev_rasterize_batch(pts, BevSpec(), valid).numpy(),
                 _golden.dense_cells(g["bev_index"], g["bev_values"], got.shape)):
        np.testing.assert_array_equal(got[..., 0] > 0, want[..., 0] > 0)
        np.testing.assert_array_equal(got[..., 1:], want[..., 1:])
        np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=0, atol=1e-4)


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("tag,dtype", [("f32", "float32"), ("bf16", "bfloat16")])
def test_fusion_net_matches_golden(cuda_device, tag, dtype, precision):
    """The shipped fusion asset on the golden's 8 frames against JAX's
    answer, also with the process's float32 matmuls set to TF32: the net
    pins full float32 for its dense layers."""
    from tpufusion_torch import _golden
    from tpufusion_torch.models.io import fusion_from_asset

    g = load_npz(GOLDEN_FUSION)
    data = _golden.fusion_golden_data(cuda_device)
    np.testing.assert_array_equal(data["cam_sha256"], g["fusion_cam_sha256"])
    torch.set_float32_matmul_precision(precision)
    net = fusion_from_asset(FUSION_ASSET, cuda_device, dtype)
    with torch.inference_mode():
        lidar = range_view_project_batch(
            torch.from_numpy(g["fusion_points"]).to(cuda_device), SPEC,
            torch.from_numpy(g["fusion_valid"]).to(cuda_device))
        centroid, rz = net(torch.from_numpy(data["cam"]).to(cuda_device), lidar,
                           torch.from_numpy(g["fusion_radar"]).to(cuda_device))
    atol = _golden.F32_FUSION_ATOL if tag == "f32" else _golden.BF16_FUSION_ATOL
    np.testing.assert_allclose(centroid.cpu().numpy(), g[f"fusion_{tag}_centroid"], rtol=0, atol=atol)
    np.testing.assert_allclose(
        rz.cpu().numpy(), g[f"fusion_{tag}_rz"], rtol=0, atol=_golden.FUSION_RZ_ATOL)
    assert torch.get_float32_matmul_precision() == precision


@pytest.mark.parametrize("host_ring", [0, 2, 3])
def test_replay_ring_is_pinned_and_answers_like_the_step(cuda_device, host_ring):
    """150 frames at chunk 64 (a padded last chunk) through the pinned
    ring and the copy stream: the same poses as make_e2e_step on the
    same chunks."""
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.serve.replay import ReplayHarness

    mcfg, dcfg = asset_configs(ASSET)
    model = FCN(mcfg)
    load_state_npz(ASSET, model)
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg)
    points = np.concatenate([
        synthesize_beam_scan_batch(np.random.default_rng(40 + i), 50)[0] for i in range(3)])
    harness = ReplayHarness(cfg, model, chunk=64, host_ring=host_ring, device=cuda_device)
    poses, founds, stats = harness.run(points)
    if host_ring:
        assert len(harness._ring) == host_ring
        assert all(h.is_pinned() and d.is_cuda for h, d, _ in harness._ring)
    step = make_e2e_step(model, SPEC, dcfg, head=mcfg.head, device=cuda_device)
    padded = np.concatenate([points, np.repeat(points[-1:], 42, axis=0)])
    for lo in range(0, 150, 64):
        p, f = step(padded[lo : lo + 64])
        n = min(64, 150 - lo)
        np.testing.assert_array_equal(founds[lo : lo + n], f.cpu().numpy()[:n])
        assert np.abs(poses[lo : lo + n] - p.cpu().numpy()[:n]).max() <= 1e-5
    assert founds.mean() > 0.9 and stats.frames == 192
