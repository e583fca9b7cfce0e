"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), is
marked `cuda`, and skips where there is none. The file imports no JAX, so
it runs on a machine with the card but without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py imports jax; the file imports nothing
from the tests directory either, whose name another installed package may
shadow.) The adversarial kernel inputs are
`tpufusion_torch/ops/parity_inputs.py`'s, which chip_smoke.py phases 2-3
run too. Tolerance: none — the kernels compute exact integer answers,
and the pixel kernel's floats are its plain version's bit for bit;
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
from tpufusion_torch.ops import cc, components, parity_inputs, pixels, projection
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline

pytestmark = pytest.mark.cuda
SPEC = RangeViewSpec()
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(_REPO, "tests", "data", "torch_port_golden_multi.npz")
GOLDEN_TALL = os.path.join(_REPO, "tests", "data", "torch_port_golden_tall.npz")
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


def _assert_cc_kernel_equals_converged_sweeps(mask):
    """One kernel launch on a (B, H, W) CUDA mask: labels equal to the
    plain sweeps run to convergence, extents equal on foreground, the
    background constants."""
    before = cc.LAUNCHES
    got = cc.connected_components_with_bbox(mask)
    _, sweeps = components.propagate(components.init_state(mask), mask, 16384)
    want = components.connected_components_with_bbox(mask, 16384)
    torch.cuda.synchronize()
    assert cc.LAUNCHES == before + 1
    assert int(sweeps.max()) < 16384  # the plain sweeps converged
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[mask], w[mask])
    big = components._BIG
    bg = ~mask
    assert (got[1][bg] == big).all() and (got[2][bg] == -big).all()
    assert (got[3][bg] == big).all() and (got[4][bg] == -big).all()


@pytest.mark.parametrize("height", parity_inputs.CC_HEIGHTS)
@pytest.mark.parametrize("batch", parity_inputs.CC_BATCHES)
def test_cc_kernel_adversarial_masks(cuda_device, batch, height):
    """Full foreground, serpentines across every column and row border, a
    comb and stripes on the border columns and rows, a comb whose teeth
    meet only through its spine, a checkerboard, blobs at columns 0 and
    1800, dense noise on the ragged last column and row tiles, frame b's
    last tile beside frame b+1's first; at 32 to 128 rows (one to four row
    tiles, 33 and 63 ragged); the plain sweeps run to convergence."""
    mask = parity_inputs.cc_batch(batch, height=height)
    _assert_cc_kernel_equals_converged_sweeps(torch.from_numpy(mask).to(cuda_device))


def test_cc_kernel_merges_a_mask_of_12000_border_pairs(cuda_device):
    """32 x 24,001 (376 column tiles): every other row full, 16 rows across
    375 column borders, and noise of 0.4."""
    rng = np.random.default_rng(11)
    mask = np.zeros((2, 32, 24001), bool)
    mask[0, ::2] = True
    mask[1] = rng.random((32, 24001)) < 0.4
    _assert_cc_kernel_equals_converged_sweeps(torch.from_numpy(mask).to(cuda_device))


def test_cc_kernel_rejects_bad_inputs(cuda_device):
    mask = torch.zeros((2, 32, 181), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="bool"):
        cc.connected_components_with_bbox(mask.to(torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        cc.connected_components_with_bbox(mask.transpose(1, 2))
    with pytest.raises(ValueError, match="impl"):
        cc.connected_components_with_bbox(mask, 128, "scan")


def _same_bits(got, want) -> bool:
    got, want = got.cpu(), want.cpu()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.shape == want.shape and torch.equal(got, want)


def _pixel_cases():
    """(label, points, valid, spec): the main path's beam scans, config 5's,
    the 63-row view's, and the adversarial points (C = 4 and 3, masked and
    not) at both heights; numpy."""
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG

    tall = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    p, _, v = synthesize_beam_scan_batch(np.random.default_rng(0), 64, 32768)
    yield "beam scans 64 x 32,768", p, v, SPEC
    p, _, v = synthesize_beam_scan_batch(np.random.default_rng(600), 16, 131072, n_beams=64)
    yield "config 5, 16 x 131,072", p, v, SPEC
    p, _, v = synthesize_beam_scan_batch(np.random.default_rng(3), 64, 32768, n_beams=TALL_BEAMS)
    yield "63 rows", p, v, tall
    for spec in (SPEC, tall):
        for channels in (4, 3):
            p, v = parity_inputs.pixel_points(spec, batch=4, n=32768, channels=channels)
            yield f"adversarial C={channels} at {spec.height} rows", p, v, spec
        yield f"adversarial, no mask, at {spec.height} rows", p, None, spec


def test_pixel_kernel_is_bit_identical(cuda_device):
    """tf_project_points against its plain version run on the CPU and on
    the card: pixel ids, keys, validity and payload, bit for bit."""
    for label, p, v, spec in _pixel_cases():
        pts = torch.from_numpy(p).to(cuda_device)
        valid = None if v is None else torch.from_numpy(v).to(cuda_device)
        before = pixels.LAUNCHES
        got = pixels.project_points(pts, valid, spec)
        torch.cuda.synchronize()
        assert pixels.LAUNCHES == before + 1
        want = pixels.project_points_reference(torch.from_numpy(p), None if v is None else
                                               torch.from_numpy(v), spec)
        card = pixels.project_points_reference(pts, valid, spec)
        for g, w, c in zip(got, want, card):
            assert _same_bits(g, w), label
            assert _same_bits(c, w), label


def test_project_2d_kernel_is_bit_identical(cuda_device):
    """tf_project_2d against its plain version on seeded box corners and
    the adversarial coordinates, at 32 and 63 rows."""
    from tpufusion_torch._golden import TALL_RES_V_DEG
    from tpufusion_torch.geometry.boxes import box_corners_3d

    rng = np.random.default_rng(5)
    n = 4096
    center = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                       rng.uniform(-2.5, 0.5, n)], -1).astype(np.float32)
    size = np.float32([4.2, 1.6, 1.5]) * rng.uniform(0.7, 1.4, (n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    corners = box_corners_3d(torch.from_numpy(center)[:, None], torch.from_numpy(size)[:, None],
                             torch.from_numpy(yaw)[:, None]).reshape(-1, 3)
    xyz = torch.cat([corners, torch.from_numpy(parity_inputs.pixel_fixed_points())])
    for spec in (SPEC, RangeViewSpec(res_v_deg=TALL_RES_V_DEG)):
        cols = [xyz[:, i].contiguous() for i in range(3)]
        want = pixels.project_2d_reference(*cols, spec)
        before = pixels.LAUNCHES_2D
        got = pixels.project_2d(*(c.to(cuda_device) for c in cols), spec)
        card = pixels.project_2d_reference(*(c.to(cuda_device) for c in cols), spec)
        torch.cuda.synchronize()
        assert pixels.LAUNCHES_2D == before + 1
        for g, w, c in zip(got, want, card):
            assert _same_bits(g, w) and _same_bits(c, w)


def test_sorted_projected_corners_is_one_launch(cuda_device):
    """The label encode's corners and center share one project_2d launch a
    box batch; the result is the two-call form's and the CPU's bit for
    bit, at 32 and 63 rows."""
    from tpufusion_torch._golden import TALL_RES_V_DEG
    from tpufusion_torch.geometry import boxes
    from tpufusion_torch.ops.libm_f32 import sqrt_f32

    def two_calls(center, size, yaw, spec):
        corners = boxes.box_corners_3d(center, size, yaw)
        ccol, crow = boxes.project_2d(corners[..., 0], corners[..., 1], corners[..., 2], spec)
        pcol, prow = boxes.project_2d(center[..., 0], center[..., 1], center[..., 2], spec)
        d = sqrt_f32((ccol - pcol[..., None]).to(torch.float32) ** 2
                     + (crow - prow[..., None]).to(torch.float32) ** 2)
        both = torch.stack([ccol, crow], dim=-1)
        order = torch.argsort(d, dim=-1, stable=True)
        return torch.gather(both, -2, order[..., None].expand(both.shape))

    rng = np.random.default_rng(11)
    center = np.stack([rng.uniform(-60, 60, (32, 4)), rng.uniform(-60, 60, (32, 4)),
                       rng.uniform(-2.5, 0.5, (32, 4))], -1).astype(np.float32)
    size = (np.float32([4.2, 1.6, 1.5]) * rng.uniform(0.7, 1.4, (32, 4, 3))).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, (32, 4)).astype(np.float32)
    for spec in (SPEC, RangeViewSpec(res_v_deg=TALL_RES_V_DEG)):
        cpu = [torch.from_numpy(a) for a in (center, size, yaw)]
        card = [a.to(cuda_device) for a in cpu]
        before = pixels.LAUNCHES_2D
        got = boxes.sorted_projected_corners(*card, spec)
        torch.cuda.synchronize()
        assert pixels.LAUNCHES_2D == before + 1
        assert torch.equal(got, two_calls(*card, spec))
        assert torch.equal(got.cpu(), boxes.sorted_projected_corners(*cpu, spec))


def test_pixel_kernel_rejects_bad_inputs(cuda_device):
    pts = torch.zeros((2, 64, 4), device=cuda_device)
    valid = torch.ones((2, 64), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        pixels.project_points(pts.double(), valid, SPEC)
    with pytest.raises(ValueError, match="contiguous"):
        pixels.project_points(pts.transpose(0, 1).contiguous().transpose(0, 1), valid, SPEC)
    with pytest.raises(ValueError, match="CUDA"):
        pixels.project_points(pts, valid.cpu(), SPEC)
    with pytest.raises(ValueError, match="bool"):
        pixels.project_points(pts, valid.to(torch.uint8), SPEC)
    with pytest.raises(ValueError, match="C >= 3"):
        pixels.project_points(pts[..., :2].contiguous(), valid, SPEC)
    with pytest.raises(ValueError, match="shape"):
        pixels.project_2d(pts[0, :, 0].contiguous(), pts[0, :32, 1].contiguous(),
                          pts[0, :, 2].contiguous(), SPEC)


def test_the_cards_range_views_of_the_bench_golden_are_the_cpus(cuda_device):
    """The headline's frames (tests/data/torch_port_golden_bench.npz): the
    card's range views equal the CPU's, which are eager JAX's."""
    g = load_npz(os.path.join(_REPO, "tests", "data", "torch_port_golden_bench.npz"))
    for key, vkey in (("points", "valid"), ("entry_points", None)):
        pts = torch.from_numpy(g[key])
        valid = None if vkey is None else torch.from_numpy(g[vkey])
        want = range_view_project_batch(pts, SPEC, valid)
        got = range_view_project_batch(pts.to(cuda_device), SPEC,
                                       None if valid is None else valid.to(cuda_device))
        assert _same_bits(got, want), key


def test_main_path_runs_both_kernels_and_matches_golden(cuda_device):
    pipe = LidarPipeline.from_asset(ASSET, cuda_device)
    step = make_e2e_step(pipe.model, pipe.cfg.range_view, pipe.cfg.decode, head="direct")
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
    poses, found = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head="direct")(
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
        got = decode._find_obstacles_topk_batch(torch.from_numpy(prob).to(cuda_device), cfg, k)
        want = decode._find_obstacles_topk_batch(torch.from_numpy(prob), cfg, k)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
        for f in range(len(prob)):  # the public form: one frame
            got = decode.find_obstacles_topk(torch.from_numpy(prob[f]).to(cuda_device), cfg, k)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b[f].to(a.dtype))


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


# -- training on the card ------------------------------------------------------

GOLDEN_TRAIN = os.path.join(_REPO, "tests", "data", "torch_port_golden_train.npz")


@pytest.mark.parametrize("case", ["direct_f32", "corner_f32", "direct_bf16"])
def test_train_step_matches_the_reference_on_the_card(cuda_device, case):
    """One make_train_step call at full width (4 x 32,768 points, the
    shipped asset's model) against the reference's step: labels, loss,
    metrics, every gradient tensor, the BatchNorm statistics; one z-buffer
    launch, no CC launch."""
    from tpufusion_torch import _golden

    golden, gm = load_npz(GOLDEN_TRAIN), load_npz(GOLDEN_MULTI)
    batch = _golden.train_golden_inputs()
    assert str(batch["sha256"]) == str(golden["inputs_sha256"])
    shifts = golden.get(f"{case}/shifts")
    labels = _golden.port_case_labels(case, ASSET, gm, batch, cuda_device, shifts)
    same, label_abs = _golden.label_readings(labels, golden, case)
    assert same and label_abs <= _golden.TRAIN_LABEL_ATOL
    z, c = projection.LAUNCHES, cc.LAUNCHES
    got = _golden.port_train_case(case, ASSET, gm, batch, cuda_device, shifts)
    assert (projection.LAUNCHES, cc.LAUNCHES) == (z + 1, c)
    readings = _golden.train_case_readings(got, golden, case)
    for k, limit in _golden.train_case_limits(case).items():
        assert readings[k] <= limit, (k, readings)
    assert readings["metrics_abs"] <= 1e-3


@pytest.mark.parametrize("tag, dtype", [("f32", "float32"), ("bf16", "bfloat16")])
def test_fusion_step_matches_the_reference_on_the_card(cuda_device, tag, dtype):
    from tpufusion_torch import _golden

    gf, gt = load_npz(GOLDEN_FUSION), load_npz(GOLDEN_TRAIN)
    data = _golden.fusion_golden_data(cuda_device)
    data["radar"] = gf["fusion_radar"]
    with torch.no_grad():
        lidar = range_view_project_batch(
            torch.from_numpy(gf["fusion_points"]).to(cuda_device), SPEC,
            torch.from_numpy(gf["fusion_valid"]).to(cuda_device))
    got = _golden.port_fusion_step(FUSION_ASSET, dtype, data, lidar, cuda_device)
    r = _golden.fusion_step_readings(got, gt, tag)
    assert r["loss_rel"] <= _golden.FUSION_TRAIN_LOSS_RTOL[tag] and not r["over"], r


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_max_pool_gradient_ties_on_the_card_go_where_the_cpus_go(cuda_device, dtype):
    """cuDNN's / ATen's max-pool backward sends a tied window's gradient to
    the first maximum in row-major order, as the CPU's and the reference's."""
    from tpufusion_torch.models.fusion import _max_pool_nhwc

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 3, (2, 16, 40, 2)).astype(np.float32))
    grads = []
    for device in ("cpu", cuda_device):
        for pool in ((2, 8), (8, 8)):
            w = torch.from_numpy(
                np.random.default_rng(1).normal(size=(2, 16 // pool[0], 40 // pool[1], 2))
                .astype(np.float32)).to(device)
            xt = x.clone().to(device).requires_grad_()  # a leaf on its device
            (_max_pool_nhwc(xt.to(dtype), pool).float() * w).sum().backward()
            grads.append(xt.grad.cpu())
    assert torch.equal(grads[0], grads[2]) and torch.equal(grads[1], grads[3])


def test_checkpoint_round_trips_on_the_card(cuda_device, tmp_path):
    """Trainer.fit, a checkpoint, resume into a fresh trainer: the same
    weights, moments and generator state, and the same next step's loss."""
    from tpufusion_torch.config import DEFAULT, ModelConfig, TrainConfig
    from tpufusion_torch.data.pipeline import BatchPipeline
    from tpufusion_torch.train.trainer import Trainer

    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(5), 16)
    data = {"points": pts, "valid": valid, **gt}
    cfg = DEFAULT.replace(
        model=ModelConfig(dtype="bfloat16"),
        train=TrainConfig(batch_size=8, epochs=1, augment=True, learning_rate=3e-3))
    trainer = Trainer(cfg, outdir=str(tmp_path / "run"), device=cuda_device)
    pipe = BatchPipeline(data, 8, seed=0, device=cuda_device)
    z = projection.LAUNCHES
    hist = trainer.fit(pipe)
    assert projection.LAUNCHES == z + 2 and np.isfinite(hist.batch["loss"]).all()
    resumed = Trainer(cfg, outdir=str(tmp_path / "run"), device=cuda_device)
    assert resumed.resume() and resumed.step == 2
    for a, b in zip(trainer.model.parameters(), resumed.model.parameters()):
        assert b.is_cuda and torch.equal(a, b)
        assert torch.equal(trainer.optimizer.state[a]["nu"], resumed.optimizer.state[b]["nu"])
    probe = next(iter(pipe))
    la, _ = trainer.train_step(trainer.model, trainer.optimizer, probe, trainer.generator)
    lb, _ = resumed.train_step(resumed.model, resumed.optimizer, probe, resumed.generator)
    assert float(la) == float(lb)


def test_config4_row_on_the_card(cuda_device):
    """Config 4 with the shipped asset: both kernels once a step, the
    detector's scores on 128 generated frames, and the companion rows'
    (the wide-yaw asset, the mixed-family asset on three surfaces)."""
    import json

    from tpufusion_torch import benchmarks

    z, c = projection.LAUNCHES, cc.LAUNCHES
    row = benchmarks.config4_full_eval(cuda_device, reps=1)
    # warm-up, 4 timed, warm-up + 4 for the device time, 4 drained; then
    # 4 batches a companion protocol: wide yaw, circle, ellipse, box
    steps = 1 + 4 + 1 + 4 + 4 + 4 * 4
    assert (projection.LAUNCHES - z, cc.LAUNCHES - c) == (steps, steps)
    json.dumps(row, allow_nan=False)
    assert row["wide_yaw"]["detection_rate"] >= 0.9
    assert all(f["detection_rate"] >= 0.9 for f in row["mixed_family"]["per_family"].values())
    assert row["config"] == 4 and row["weights"] == "asset" and row["head"] == "direct"
    assert row["timer"] == "CUDA events" and row["value"] > 0
    assert row["detection_rate"] >= 0.9 and row["recall@iou0.25"] >= 0.8 and row["mean_xy_err"] < 1.0
    with pytest.raises(ValueError, match="weights"):
        benchmarks.config4_full_eval(cuda_device, weights="fallback")


def test_mesh_of_one_is_the_plain_step(cuda_device):
    """A data-parallel mesh of one over NCCL: after 2 train steps (bf16
    default widths, corner head, the roll on) the loss, metrics, gradients,
    parameters and BatchNorm statistics equal the plain step's bit for
    bit, cuDNN set deterministic (its wgrad may sum in another order a
    call otherwise)."""
    import torch.distributed as dist

    from tpufusion_torch.config import LossConfig, MeshConfig, ModelConfig, TrainConfig
    from tpufusion_torch.parallel.mesh import make_mesh
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(19), 4, 8192)
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in {"points": pts, "valid": valid, **gt}.items()}
    mesh = make_mesh(MeshConfig(n_devices=1), device=cuda_device)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs = []
        for m in (None, mesh):
            model = FCN(ModelConfig(dtype="bfloat16"), seed=0).to(cuda_device)
            opt, gen = Adam(model.parameters(), 3e-3), torch.Generator(device=cuda_device).manual_seed(0)
            step = make_train_step(SPEC, LossConfig(), TrainConfig(batch_size=4), mesh=m, device=cuda_device)
            steps = [step(model, opt, batch, gen) for _ in range(2)]
            outs.append({**{f"loss{i}": loss for i, (loss, _) in enumerate(steps)},
                         **{f"{k}{i}": v for i, (_, ms) in enumerate(steps) for k, v in ms.items()},
                         **{f"grad/{n}": p.grad for n, p in model.named_parameters()},
                         **{f"param/{n}": p.detach() for n, p in model.named_parameters()},
                         **{f"buffer/{n}": b for n, b in model.named_buffers()}})
        plain, meshed = outs
        assert sorted(plain) == sorted(meshed)
        assert [k for k in plain if not torch.equal(plain[k], meshed[k])] == []
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def test_halo_exchanged_fcn_on_two_ranks_of_the_card(cuda_device):
    """The FCN width-sharded over a 1 x 2 spatial mesh of two gloo ranks
    sharing the card, its halo exchanged between them, against the
    unsharded FCN on the card at 32 x 1801: float32 within 1e-5 of the
    largest output; bf16 within the bf16 FCN's limits (probabilities 2^-8,
    regression 2^-4, at most 5 % of regression outputs differing at all);
    7 exchanges of 16 columns a forward on each rank."""
    from tpufusion_torch.config import ModelConfig
    from tpufusion_torch.parallel import dryrun

    asset = dataclasses.replace(ModelConfig(), head="direct", width_multiplier=2,
                                reg_output_activation="linear")
    cases = {"asset_f32": asset, "asset_bf16": dataclasses.replace(asset, dtype="bfloat16"),
             "corner_bf16": ModelConfig(dtype="bfloat16")}
    got = dryrun.sharded_fcn_readings(2, cases, device=cuda_device, backend="gloo")
    for name, r in got.items():
        assert r["finite"] and r["ranks_halo"] == [[7, 16], [7, 16]], (name, r)
    assert got["asset_f32"]["rel"] <= 1e-5, got["asset_f32"]
    for name in ("asset_bf16", "corner_bf16"):
        r = got[name]
        assert r["prob_abs"] <= BF16_PROB_ATOL and r["reg_abs"] <= BF16_REG_ATOL, (name, r)
        assert r["reg_differ_share"] <= BF16_REG_DIFFER_SHARE, (name, r)


@pytest.mark.parametrize("streaming", [False, True], ids=["in_ram", "streaming"])
def test_bag_extraction_on_the_card_equals_the_cpus(cuda_device, tmp_path, streaming):
    """`extract_bag_dataset` of one lz4 bag (6 beam scans of varying size,
    NaN-padded into batches of 4, a camera stream) with the BEV, on the card
    and on the CPU: the range views bit for bit (the z-buffer kernel launched
    once a batch), the BEV's cells and max channels bit for bit and its
    density within 1e-4, the camera frames and every CSV equal."""
    import filecmp

    from tpufusion_torch.config import BevSpec
    from tpufusion_torch.data.etl import extract_bag_dataset, load_camera_extracted, load_extracted
    from tpufusion_torch.data.rosbag_reader import BagWriter, serialize_image, serialize_pointcloud2

    rng = np.random.default_rng(12)
    pts, _, valid = synthesize_beam_scan_batch(rng, 6)
    bag = str(tmp_path / "drive.bag")
    w = BagWriter(compression="lz4")
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    w.add_connection(1, "/image_raw", "sensor_msgs/Image")
    for i in range(6):
        w.add_message(0, 10**9 * (i + 1), serialize_pointcloud2(pts[i][valid[i]]))
        w.add_message(1, 10**9 * (i + 1) + 7, serialize_image(rng.integers(0, 255, (40, 50), np.uint8)))
    w.write(bag)
    outs = {}
    for tag, dev in (("card", cuda_device), ("cpu", "cpu")):
        out = str(tmp_path / tag)
        z = projection.LAUNCHES
        extract_bag_dataset(bag, out, crop=(5, 35), bev=BevSpec(), streaming=streaming, batch=4,
                            device=dev)
        assert projection.LAUNCHES - z == (2 if tag == "card" else 0)
        layout = "npy" if streaming else "npz"
        bev = np.load(os.path.join(out, f"bev_frames.{layout}"))
        outs[tag] = (out, load_extracted(out), bev if streaming else bev["images"])
    (card_dir, card, card_bev), (cpu_dir, cpu, cpu_bev) = outs.values()
    np.testing.assert_array_equal(np.asarray(card["images"]), np.asarray(cpu["images"]))
    np.testing.assert_array_equal(card_bev[..., 1:], cpu_bev[..., 1:])
    np.testing.assert_array_equal(card_bev[..., 0] > 0, cpu_bev[..., 0] > 0)
    assert np.abs(card_bev[..., 0] - cpu_bev[..., 0]).max() <= 1e-4
    np.testing.assert_array_equal(np.asarray(load_camera_extracted(card_dir)["images"]),
                                  np.asarray(load_camera_extracted(cpu_dir)["images"]))
    for name in ("lidar_timestamps.csv", "camera_timestamps.csv"):
        assert filecmp.cmp(os.path.join(card_dir, name), os.path.join(cpu_dir, name), shallow=False)


@pytest.mark.parametrize("min_prob", [0.05, 0.5, 0.9])
def test_cc_kernel_on_the_tuners_heat_masks(cuda_device, min_prob):
    """The heat masks the operating-point tuner decodes
    (`tools/tune_detector_asset.py`): the shipped asset's FCN (bf16, as
    `benchmarks.asset_model` builds it) on 8 beam scans at the sparse
    sweep of its per-resolution pass, 16,384 points, thresholded down to
    min_prob 0.05, which gives the largest components any path gives the
    kernel; against the plain sweeps run to convergence."""
    from tpufusion_torch.benchmarks import asset_model

    model, dcfg, _ = asset_model(ASSET)
    model.to(cuda_device).eval()
    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(999), 8, 16384)
    with torch.inference_mode():
        images = range_view_project_batch(torch.from_numpy(pts).to(cuda_device), SPEC,
                                          torch.from_numpy(valid).to(cuda_device))
        mask = decode.heat_mask(model(images)[..., 1], dataclasses.replace(dcfg, min_prob=min_prob))
        got = cc.connected_components_with_bbox(mask)
        _, sweeps = components.propagate(components.init_state(mask), mask, 16384)
        want = components.connected_components_with_bbox(mask, 16384)
    torch.cuda.synchronize()
    assert int(sweeps.max()) < 16384 and mask.any()
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g[mask], w[mask])


@pytest.mark.parametrize("n_points", [16384, 65536])
@pytest.mark.parametrize("surface", ["ellipse", "box"])
def test_projection_kernel_on_the_envelopes_surfaces(cuda_device, surface, n_points):
    """Clouds of the envelope's surface and resolution conditions
    (`tools/detector_envelope.py`): 8 beam scans with ellipse or box
    vehicles at yaw +-0.4, the sparse and the dense sweep."""
    pts, _, valid = synthesize_beam_scan_batch(
        np.random.default_rng(999), 8, n_points, max_yaw=0.4, vehicle_surface=surface)
    args = _frame_pixels_keys(torch.from_numpy(pts).to(cuda_device), SPEC,
                              torch.from_numpy(valid).to(cuda_device))
    before = projection.LAUNCHES
    got = projection.nearest_wins_image(*args, SPEC)
    want = projection.nearest_wins_image_reference(*args, SPEC)
    torch.cuda.synchronize()
    assert projection.LAUNCHES == before + 1
    assert torch.equal(got, want)


def test_queued_timer_measures_the_card_and_refuses_a_readback(cuda_device):
    """`kernel_bench.queued_ms` times the z-buffer kernel's calls queued
    behind a sleep: a positive time no longer than a call's between
    events (which adds the host's launch work); a function that reads
    back from the card cannot be queued, and the timer raises."""
    from tpufusion_torch.kernel_bench import queued_ms, time_ms

    sets = [_proj_inputs(cuda_device, seed=s) for s in range(4)]

    def run(a):
        return projection.nearest_wins_image(*a, SPEC)

    queued, call = queued_ms(run, sets), time_ms(run, sets)
    assert 0 < queued <= call
    with pytest.raises(RuntimeError, match="did not queue"):
        queued_ms(lambda a: int(run(a)[0, 0, 0, 0].item()), sets, tries=2)


def test_single_frame_entry_points_launch_the_kernels(cuda_device):
    """range_view_project: one z-buffer launch, bit-equal to the batch row
    and to the CPU; connected_components: one CC launch, the plain sweeps'
    labels; decode_frame_direct: one CC launch, the batch decode's row."""
    from tpufusion_torch.decode.decode import decode_frame_direct, heat_mask
    from tpufusion_torch.geometry.range_view import range_view_project
    from tpufusion_torch.ops.components import connected_components

    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(12), 2, 32768)
    before = projection.LAUNCHES
    img = range_view_project(torch.from_numpy(pts[0]).to(cuda_device), SPEC,
                             torch.from_numpy(valid[0]).to(cuda_device))
    assert projection.LAUNCHES == before + 1
    batch = range_view_project_batch(torch.from_numpy(pts).to(cuda_device), SPEC,
                                     torch.from_numpy(valid).to(cuda_device))
    assert torch.equal(img, batch[0])
    cpu = range_view_project(torch.from_numpy(pts[0]), SPEC, torch.from_numpy(valid[0]))
    assert torch.equal(img.cpu(), cpu)

    mcfg, dcfg = asset_configs(ASSET)
    model = FCN(mcfg)
    load_state_npz(ASSET, model)
    model = model.to(cuda_device).eval()
    with torch.inference_mode():
        preds = model(batch)
        mask = heat_mask(preds[..., 1], dcfg)[0]
        before = cc.LAUNCHES
        labels = connected_components(mask)
        assert cc.LAUNCHES == before + 1
        assert torch.equal(labels.cpu(), components.connected_components_reference(mask.cpu(), 16384))
        one = decode_frame_direct(preds[0], batch[0], SPEC, dcfg)
        assert cc.LAUNCHES == before + 2
        row = decode.decode_batch_direct(preds[:1], batch[:1], SPEC, dcfg)
        rows = decode.decode_batch_direct(preds, batch, SPEC, dcfg)
    for key in ("poses", "found", "areas"):
        assert torch.equal(one[key], row[key][0]), key
    # a batch of two sums in other kernels on the card: the last bits may move
    assert torch.equal(one["found"], rows["found"][0]) and bool(one["found"][0])
    assert _pose_diff(one["poses"], rows["poses"][0].cpu().numpy()) < POSE_TOL


def test_connected_components_refuses_a_mask_taller_than_the_kernel(cuda_device):
    """The reference labels a mask of any height, and so does the kernel: a
    64-row CUDA mask (two row tiles) takes one kernel launch, never the
    plain sweeps, and gets the plain sweeps' labels."""
    from tpufusion_torch.ops.components import connected_components

    for name in ("full", "serpentine", "comb_rows", "row_stripes"):
        mask = torch.from_numpy(parity_inputs.cc_frames(height=64, width=100)[name])
        before = cc.LAUNCHES
        labels = connected_components(mask.to(cuda_device))
        assert cc.LAUNCHES == before + 1
        assert labels.is_cuda
        want = components.connected_components_reference(mask, 16384)
        assert torch.equal(labels.cpu(), want), name


def test_e2e_step_at_63_rows_matches_the_cpu_and_golden(cuda_device):
    """A 64-beam sensor's 63 x 1801 range view, the shipped asset's direct
    step: the card against the port on the CPU (8 x 32,768 points) and
    against the tall JAX golden; both kernels launched."""
    from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG

    spec = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
    mcfg, dcfg = asset_configs(ASSET)
    model = FCN(mcfg)
    load_state_npz(ASSET, model)
    model = model.eval()
    points, _, valid = synthesize_beam_scan_batch(np.random.default_rng(63), 8, 32768,
                                                  n_beams=TALL_BEAMS)
    cpu_poses, cpu_found = make_e2e_step(model, spec, dcfg, head="direct", device="cpu")(
        points, valid)
    step = make_e2e_step(model.to(cuda_device), spec, dcfg, head="direct")
    p0, c0 = projection.LAUNCHES, cc.LAUNCHES
    poses, found = step(points, valid)
    torch.cuda.synchronize()
    assert projection.LAUNCHES == p0 + 1 and cc.LAUNCHES == c0 + 1
    np.testing.assert_array_equal(found.cpu().numpy(), cpu_found.numpy())
    assert found.sum() >= 6
    assert _pose_diff(poses, cpu_poses.numpy()) < POSE_TOL
    g = load_npz(GOLDEN_TALL)
    poses, found = step(g["points"], g["valid"])
    np.testing.assert_array_equal(found.cpu().numpy(), g["found"])
    assert _pose_diff(poses, g["poses"]) < POSE_TOL


def test_view_dataset_on_the_card(cuda_device, tmp_path):
    """view_dataset on a raw points npz with a checkpoint, on the card: one
    z-buffer launch a frame, the pushed range view the render of the CPU's
    projection, every window pushed once a frame."""
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.geometry.range_view import range_view_project
    from tpufusion_torch.serve import viewer
    from tpufusion_torch.tools.visualize import render_range_view
    from tpufusion_torch.train.checkpoint import CheckpointManager

    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(13), 3, 32768)
    pts = np.where(valid[..., None], pts, np.nan).astype(np.float32)
    np.savez(tmp_path / "raw.npz", points=pts)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, FCN(DEFAULT.model, in_channels=3, seed=0))
    pushed = []
    orig = viewer.LiveViewer.push
    viewer.LiveViewer.push = lambda self, name, frame: pushed.append((name, np.array(frame)))
    try:
        before = projection.LAUNCHES
        viewer.view_dataset(str(tmp_path / "raw.npz"), str(tmp_path / "ckpt"), port=0,
                            rate_hz=1000.0, device=cuda_device)
        assert projection.LAUNCHES == before + 3
    finally:
        viewer.LiveViewer.push = orig
    assert [n for n, _ in pushed] == ["bev", "range_view", "class_mask"] * 3
    for i, (_, frame) in enumerate(p for p in pushed if p[0] == "range_view"):
        want = render_range_view(range_view_project(torch.from_numpy(pts[i]), SPEC).numpy(), spec=SPEC)
        np.testing.assert_array_equal(frame, want)


GOLDEN_BENCH = os.path.join(_REPO, "tests", "data", "torch_port_golden_bench.npz")
GOLDEN_PACKED = os.path.join(_REPO, "tests", "data", "torch_port_golden_packed.npz")
TALL = RangeViewSpec(res_v_deg=0.665)  # a 64-beam sensor's 63 x 1801


def _packed_case(name: str, device):
    """(pixel-kernel inputs on `device`, spec) of one of chip_smoke phase
    27 (a)'s sets: clouds through the pixel kernel, or the adversarial
    z-buffer arguments."""
    from tpufusion_torch._golden import near_tie_sets

    if name.startswith(("bench", "near_ties", "nan")):
        if name.startswith("nan"):
            points, valid = parity_inputs.nan_clouds(2, int(name.split("_")[1]))
        else:
            g = load_npz(GOLDEN_BENCH)
            points, valid = g["points"], g["valid"]
            if name != "bench_golden":
                points, valid = near_tie_sets(points, valid)["short_" if name.endswith("short") else ""]
        return _frame_pixels_keys(torch.from_numpy(points).to(device), SPEC,
                                  torch.from_numpy(valid).to(device)), SPEC
    b, n, kinds, spec = _PACKED_ADVERSARIAL[name]
    return [torch.from_numpy(a).to(device) for a in parity_inputs.zbuffer_args(
        b, n, spec.height * spec.width, kinds=kinds)], spec


_PACKED_ADVERSARIAL = {
    f"{b}x{n}-{k[0] if len(k) == 1 else 'mixed'}": (b, n, k, SPEC)
    for b, n, k in parity_inputs.PACKED_SHAPES}
_PACKED_ADVERSARIAL["64x32768-mixed-63rows"] = (64, 32768, parity_inputs.PACKED_KINDS, TALL)


@pytest.mark.parametrize("name", ["bench_golden", "near_ties", "near_ties_short", "nan_32768",
                                  "nan_32769", *_PACKED_ADVERSARIAL])
def test_packed_kernel_is_bit_identical(cuda_device, name):
    """The packed z-buffer kernel against its plain version on the card:
    beam scans, near-tie frames, NaN / inf clouds with padding where
    idx_bits steps, and the adversarial inputs with near ties (at
    131,072 points and into 63 x 1801 too); one launch a call."""
    args, spec = _packed_case(name, cuda_device)
    before = projection.PACKED_LAUNCHES
    got = projection.nearest_wins_packed_image(*args, spec)
    want = projection.nearest_wins_packed_image_reference(*args, spec)
    torch.cuda.synchronize()
    assert projection.PACKED_LAUNCHES == before + 1
    assert _same_bits(got, want)
    cpu = projection.nearest_wins_packed_image_reference(*(a.cpu() for a in args), spec)
    assert _same_bits(got, cpu)


_PACKED_EDGES = {
    f"{b}x{n}-{'+'.join(k)}-{RangeViewSpec(res_v_deg=r).height}rows": (b, n, k, r)
    for b, n, k, r in parity_inputs.PACKED_EDGE_SETS}


@pytest.mark.parametrize("name", list(_PACKED_EDGES))
def test_packed_kernel_on_its_shared_memory_edges(cuda_device, name):
    """The packed kernel's grid in the cluster's shared memory: pixels on
    the CTAs' slice boundaries, every pixel occupied, the ragged last
    slice at 63 rows, and a 690-row image past one cluster's shared
    memory (the band path): bit for bit its plain version on the card and
    on the CPU, one launch a call."""
    b, n, kinds, res_v = _PACKED_EDGES[name]
    spec = RangeViewSpec(res_v_deg=res_v)
    args = [torch.from_numpy(a) for a in parity_inputs.zbuffer_args(
        b, n, spec.height * spec.width, kinds=kinds)]
    before = projection.PACKED_LAUNCHES
    got = projection.nearest_wins_packed_image(*(a.to(cuda_device) for a in args), spec)
    card = projection.nearest_wins_packed_image_reference(*(a.to(cuda_device) for a in args), spec)
    torch.cuda.synchronize()
    assert projection.PACKED_LAUNCHES == before + 1
    assert _same_bits(got, card)
    assert _same_bits(got.cpu(), projection.nearest_wins_packed_image_reference(*args, spec))


def test_packed_kernel_slices_and_bands(cuda_device):
    """The kernel's own plan: 3,602 slots a CTA at 32 x 1801 and 7,092 at
    63 x 1801 in one band; 690 x 1801 does not fit one cluster's shared
    memory and takes two bands; the card holds clusters of every shape."""
    import ctypes

    from tpufusion_torch import _build

    lib = _build.load()
    got = {}
    for rows, res_v in ((32, 1.33), (63, 0.665), (690, 0.06)):
        spec = RangeViewSpec(res_v_deg=res_v)
        assert spec.height == rows
        out = [ctypes.c_int() for _ in range(4)]
        err = lib.tf_nearest_wins_packed_shape(spec.height * spec.width,
                                               *(ctypes.byref(o) for o in out))
        assert err == 0, err
        got[rows] = [o.value for o in out]  # slots, shared bytes, bands, clusters
    assert got[32][0] == 3602 and got[32][2] == 1
    assert got[63][0] == 7092 and got[63][2] == 1
    assert got[690][2] == 2 and got[690][0] * 16 < 1801 * 690 <= 2 * got[690][0] * 16
    assert all(v[3] > 0 for v in got.values()), got


def test_packed_step_matches_the_cpu_and_golden(cuda_device):
    """The shipped asset's direct step with method="packed" on the near-tie
    frames: the card's range views with JAX's sha256, found and poses as
    the CPU's and the packed golden's."""
    import hashlib

    from tpufusion_torch._golden import near_tie_sets

    g, bench = load_npz(GOLDEN_PACKED), load_npz(GOLDEN_BENCH)
    points, valid = near_tie_sets(bench["points"], bench["valid"])[""]
    images = range_view_project_batch(torch.from_numpy(points).to(cuda_device), SPEC,
                                      torch.from_numpy(valid).to(cuda_device), "packed").cpu().numpy()
    assert [hashlib.sha256(im.tobytes()).hexdigest() for im in images] == g["packed_sha256"].tolist()
    pipe = LidarPipeline.from_asset(ASSET, "cpu")
    cpu_poses, cpu_found = make_e2e_step(pipe.model, SPEC, pipe.cfg.decode, "packed", head="direct",
                                         device="cpu")(points, valid)
    poses, found = make_e2e_step(pipe.model.to(cuda_device), SPEC, pipe.cfg.decode, "packed",
                                 head="direct", device=cuda_device)(points, valid)
    np.testing.assert_array_equal(found.cpu().numpy(), cpu_found.numpy())
    np.testing.assert_array_equal(found.cpu().numpy(), g["packed_step_found"])
    assert wrapped_pose_diff(poses, cpu_poses.numpy()).max() < POSE_TOL
    assert wrapped_pose_diff(poses, g["packed_step_poses"]).max() < POSE_TOL


@pytest.mark.parametrize("method", ["exact", "pallas", "scatter", "sort16", "packed"])
def test_each_method_launches_its_z_buffer_kernel(cuda_device, method):
    """A range view on the card launches the pixel kernel and one z-buffer
    kernel: the packed one for "packed", the exact one for the others."""
    args = [torch.from_numpy(a).to(cuda_device) for a in parity_inputs.nan_clouds(2, 8192)]
    before = (pixels.LAUNCHES, projection.LAUNCHES, projection.PACKED_LAUNCHES)
    got = range_view_project_batch(*args[:1], SPEC, args[1], method)
    torch.cuda.synchronize()
    packed = method == "packed"
    assert (pixels.LAUNCHES, projection.LAUNCHES, projection.PACKED_LAUNCHES) == (
        before[0] + 1, before[1] + (not packed), before[2] + packed)
    cpu = [torch.from_numpy(a) for a in parity_inputs.nan_clouds(2, 8192)]
    assert _same_bits(got, range_view_project_batch(cpu[0], SPEC, cpu[1], method))


def test_packed_kernel_rejects_bad_inputs(cuda_device):
    pix, key, ok, payload = _proj_inputs(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        projection.nearest_wins_packed_image(pix.long(), key, ok, payload, SPEC)
    with pytest.raises(ValueError, match="CUDA"):
        projection.nearest_wins_packed_image(pix, key.cpu(), ok, payload, SPEC)
