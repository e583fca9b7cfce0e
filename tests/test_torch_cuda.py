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
    F16_PROB_ATOL,
    F16_REG_ATOL,
    F16_REG_DIFFER_SHARE,
    fcn_sample_readings,
    load_npz,
    wrapped_pose_diff,
)
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.decode import decode
from tpufusion_torch.geometry.range_view import _frame_pixels_keys, range_view_project_batch
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import asset_configs, load_state_npz
from tpufusion_torch.ops import cc, components, label_encode, parity_inputs, pixels, projection
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.serve.pipeline import LidarPipeline

pytestmark = pytest.mark.cuda
SPEC = RangeViewSpec()
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSET = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
GOLDEN = os.path.join(_REPO, "tests", "data", "torch_port_golden.npz")
GOLDEN_MULTI = os.path.join(_REPO, "tests", "data", "torch_port_golden_multi.npz")
GOLDEN_TALL = os.path.join(_REPO, "tests", "data", "torch_port_golden_tall.npz")
GOLDEN_BF16 = os.path.join(_REPO, "tests", "data", "torch_port_golden_bf16.npz")
GOLDEN_F16 = os.path.join(_REPO, "tests", "data", "torch_port_golden_f16.npz")
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
    dp, dr, n_diff, n = fcn_sample_readings(
        out.cpu().numpy(), g["bf16_fcn_prob"], g["bf16_fcn_reg"]
    )
    assert dp <= BF16_PROB_ATOL and dr <= BF16_REG_ATOL
    assert n_diff <= BF16_REG_DIFFER_SHARE * n


def test_f16_top4_path_runs_in_float16_and_matches_golden(cuda_device):
    """The float16 configuration on the card: the asset's FCN in float16
    (its convs really return float16) against the float16 golden's sample
    of JAX's float16 FCN (F16_* limits), and top-4 poses against JAX's
    float16 answer (1e-4), found equal to the float32 path's."""
    from tpufusion_torch._golden import F16_E2E_K, from_f16_bits

    g, gf = load_npz(GOLDEN_MULTI), load_npz(GOLDEN_F16)
    mcfg, dcfg = asset_configs(ASSET)
    models = {}
    for dt in ("float32", "float16"):
        models[dt] = FCN(dataclasses.replace(mcfg, dtype=dt))
        load_state_npz(ASSET, models[dt])
        models[dt] = models[dt].to(cuda_device).eval()
    dtypes = []
    models["float16"].conv1.register_forward_hook(lambda m, i, o: dtypes.append(o.dtype))
    found = {}
    for dt, model in models.items():
        poses, found[dt] = make_e2e_step(model, SPEC, dcfg, max_obstacles=F16_E2E_K,
                                         head="direct")(g["multi_points"], g["multi_valid"])
        if dt == "float16":
            np.testing.assert_array_equal(found[dt].cpu().numpy(), gf["e2e_found"])
            assert _pose_diff(poses, gf["e2e_poses"]) <= 1e-4
    assert dtypes == [torch.float16]
    assert torch.equal(found["float32"], found["float16"])
    with torch.inference_mode():
        out = models["float16"](range_view_project_batch(
            torch.from_numpy(g["multi_points"]).to(cuda_device), SPEC,
            torch.from_numpy(g["multi_valid"]).to(cuda_device),
        ))
    dp, dr, n_diff, n = fcn_sample_readings(
        out.cpu().numpy(), gf["fcn_prob"], from_f16_bits(gf["fcn_reg_bits"]))
    print(f"float16 FCN: probability {dp:.3e}, regression {dr:.3e}, {n_diff} of {n} differ")
    assert dp <= F16_PROB_ATOL and dr <= F16_REG_ATOL
    assert n_diff <= F16_REG_DIFFER_SHARE * n


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
             "corner_bf16": ModelConfig(dtype="bfloat16"),
             "asset_f16": dataclasses.replace(asset, dtype="float16")}
    got = dryrun.sharded_fcn_readings(2, cases, device=cuda_device, backend="gloo")
    for name, r in got.items():
        assert r["finite"] and r["ranks_halo"] == [[7, 16], [7, 16]], (name, r)
    assert got["asset_f32"]["rel"] <= 1e-5, got["asset_f32"]
    for name in ("asset_bf16", "corner_bf16"):
        r = got[name]
        assert r["prob_abs"] <= BF16_PROB_ATOL and r["reg_abs"] <= BF16_REG_ATOL, (name, r)
        assert r["reg_differ_share"] <= BF16_REG_DIFFER_SHARE, (name, r)
    r = got["asset_f16"]  # float16 within the float16 FCN's limits
    assert r["prob_abs"] <= F16_PROB_ATOL and r["reg_abs"] <= F16_REG_ATOL, r
    assert r["reg_differ_share"] <= F16_REG_DIFFER_SHARE, r


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


# -- the fused label encode ------------------------------------------------------------


def _label_spec(rows: int) -> RangeViewSpec:
    from tpufusion_torch._golden import TALL_RES_V_DEG

    return SPEC if rows == 32 else RangeViewSpec(res_v_deg=TALL_RES_V_DEG)


@pytest.mark.parametrize("rows", [32, 63])
@pytest.mark.parametrize("kind", parity_inputs.LABEL_KINDS)
def test_label_encode_kernel_is_bit_identical(cuda_device, kind, rows):
    """The fused label-encode kernel against its plain version on the card,
    every footprint method, at 32 and 63 rows: seam boxes, boxes all
    round, an image with no return (an all-background view of the box),
    and degenerate boxes (size 0, zero length or width, yaw +-pi, centers
    on the axis and at the origin); one launch a call, no project_2d."""
    from tpufusion_torch.geometry.encoding import encode_label_reference
    from tpufusion_torch.ops import label_encode

    spec = _label_spec(rows)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in parity_inputs.label_inputs(spec, 16, kind, seed=rows)]
    for method in label_encode.METHODS:
        before = (label_encode.LAUNCHES, pixels.LAUNCHES_2D)
        got = label_encode.encode_label(*args, spec, method)
        torch.cuda.synchronize()
        assert (label_encode.LAUNCHES, pixels.LAUNCHES_2D) == (before[0] + 1, before[1])
        want = encode_label_reference(*args, spec, method)
        assert _same_bits(got, want), (kind, rows, method)


@pytest.mark.parametrize("rows", [32, 63])
def test_label_encode_kernel_on_beam_scans_at_any_leading_shape(cuda_device, rows):
    """The corner encode of projected beam scans with their boxes, through
    `encode_label` and `encode_label_batch` at leading shapes (), (B,) and
    (2, B / 2), with 2, 3 and 4 image channels: the plain version's bits,
    one kernel launch a call."""
    from tpufusion_torch.geometry import encoding
    from tpufusion_torch.ops import label_encode

    spec = _label_spec(rows)
    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(rows), 8, 32768,
                                                n_beams=64 if rows == 63 else 32)
    images = range_view_project_batch(torch.from_numpy(pts).to(cuda_device), spec,
                                      torch.from_numpy(valid).to(cuda_device))
    box = [torch.from_numpy(gt[k]).to(cuda_device) for k in ("center", "size", "yaw")]
    want = encoding.encode_label_reference(*box, images, spec)
    assert float(want[..., 1].sum()) > 0
    before = label_encode.LAUNCHES
    assert _same_bits(encoding.encode_label_batch(*box, images, spec), want)
    assert _same_bits(encoding.encode_label(*(a[3] for a in box), images[3], spec), want[3])
    halves = [a.reshape(2, 4, *a.shape[1:]) for a in box + [images]]
    assert _same_bits(encoding.encode_label(*halves, spec), want.reshape(2, 4, *want.shape[1:]))
    for channels in (2, 4):
        img = torch.cat([images, images[..., :1]], -1)[..., :channels].contiguous()
        assert _same_bits(encoding.encode_label(*box, img, spec),
                          encoding.encode_label_reference(*box, img, spec))
    torch.cuda.synchronize()
    assert label_encode.LAUNCHES == before + 5


def test_label_encode_kernel_rejects_bad_inputs(cuda_device):
    from tpufusion_torch.ops import label_encode

    center, size, yaw, image = (torch.from_numpy(a).to(cuda_device)
                                for a in parity_inputs.label_inputs(SPEC, 2))
    with pytest.raises(ValueError, match="float32"):
        label_encode.encode_label(center, size, yaw, image.double(), SPEC)
    with pytest.raises(ValueError, match="float32"):
        label_encode.encode_label(center, size, yaw, image.bfloat16(), SPEC)
    with pytest.raises(ValueError, match="C >= 2"):
        label_encode.encode_label(center, size, yaw, image[..., :1].contiguous(), SPEC)
    with pytest.raises(ValueError, match="C >= 2"):
        label_encode.encode_label(center, size, yaw, image, RangeViewSpec(res_h_deg=1.8))
    with pytest.raises(ValueError, match="contiguous"):
        label_encode.encode_label(center, size, yaw, image[..., :2], SPEC)
    with pytest.raises(ValueError, match="center must have shape"):
        label_encode.encode_label(center[0], size, yaw, image, SPEC)
    with pytest.raises(ValueError, match="yaw must have shape"):
        label_encode.encode_label(center, size, yaw[:1], image, SPEC)
    with pytest.raises(ValueError, match="unknown footprint method"):
        label_encode.encode_label(center, size, yaw, image, SPEC, "square")


# -- the direct head's fused label encode ---------------------------------------------

DIRECT_CODECS = [(fp, yf) for fp in label_encode.FOOTPRINTS for yf in label_encode.YAW_FRAMES]


def _direct_bits(args, spec, footprint, yaw_frame):
    """The direct kernel's label against its plain version on the card:
    (bit-identical, the kernel's launches, project_2d's and the corner
    kernel's launches during the kernel's call, the plain label)."""
    from tpufusion_torch.geometry.encoding import encode_direct_label_reference

    before = (label_encode.LAUNCHES_DIRECT, pixels.LAUNCHES_2D, label_encode.LAUNCHES)
    got = label_encode.encode_direct_label(*args, spec, footprint, yaw_frame)
    torch.cuda.synchronize()
    after = (label_encode.LAUNCHES_DIRECT, pixels.LAUNCHES_2D, label_encode.LAUNCHES)
    want = encode_direct_label_reference(*args, spec, footprint, yaw_frame)
    return _same_bits(got, want), tuple(a - b for a, b in zip(after, before)), want


@pytest.mark.parametrize("rows", [32, 63])
@pytest.mark.parametrize("kind", parity_inputs.LABEL_KINDS)
def test_direct_encode_kernel_is_bit_identical(cuda_device, kind, rows):
    """The direct head's label-encode kernel against its plain version on
    the card, both footprints and all three yaw frames, at 32 and 63 rows:
    seam boxes, boxes all round, an image with no return, degenerate
    boxes, and returns on and one step outside the dilated box faces (at
    yaw 0 and +-pi); one launch a call, no project_2d or corner launch."""
    spec = _label_spec(rows)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in parity_inputs.label_inputs(spec, 16, kind, seed=rows)]
    for footprint, yaw_frame in DIRECT_CODECS:
        same, launches, _ = _direct_bits(args, spec, footprint, yaw_frame)
        assert launches == (1, 0, 0), (footprint, yaw_frame, launches)
        assert same, (kind, rows, footprint, yaw_frame)


@pytest.mark.parametrize("rows", [32, 63])
def test_direct_encode_kernel_on_the_faces(cuda_device, rows):
    """`parity_inputs.face_inputs` on the card, and the kernel gives the
    plain version's bits. The returns were placed with torch's cos and sin
    on the CPU; on the columns where the card's equal them (the frames'
    yaws' do), the plain version's surface mask is 0 on every return one
    step outside a dilated face and 1 on nearly every return on one (on
    the top and bottom faces, where the height alone moves, all of
    them)."""
    spec = _label_spec(rows)
    *arrays, case = parity_inputs.face_inputs(spec, 12, seed=rows + 1)
    args = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    for yaw_frame in ("local", "both"):
        same, launches, want = _direct_bits(args, spec, "surface", yaw_frame)
        assert same and launches == (1, 0, 0), (rows, yaw_frame)
    yaw = args[2]
    assert torch.equal(torch.cos(yaw).cpu(), torch.cos(yaw.cpu()))
    assert torch.equal(torch.sin(yaw).cpu(), torch.sin(yaw.cpu()))
    card, cpu = label_encode.pixel_trig(spec, cuda_device), label_encode.pixel_trig(spec, "cpu")
    same_cols = ((card[0].cpu() == cpu[0]) & (card[1].cpu() == cpu[1])).numpy()
    assert same_cols.mean() > 0.5
    mask = want[..., 1].cpu().numpy()[..., same_cols]
    case = case[..., same_cols]
    out = (case >= 0) & (case < 8) & (case % 2 == 1)
    on = (case >= 0) & (case < 8) & (case % 2 == 0)
    top_bottom_on = (case == 4) | (case == 6)
    assert out.sum() > 1000 and not mask[out].any()
    assert mask[on].mean() > 0.9 and mask[top_bottom_on].all()


@pytest.mark.parametrize("rows", [32, 63])
def test_direct_encode_kernel_on_beam_scans_at_any_leading_shape(cuda_device, rows):
    """The direct encode of projected beam scans with their boxes, through
    `encode_direct_label` and `encode_direct_label_batch` at leading
    shapes (), (B,) and (2, B / 2), with 2, 3 and 4 image channels, each
    footprint and yaw frame: the plain version's bits, one kernel launch a
    call."""
    from tpufusion_torch.geometry import encoding

    spec = _label_spec(rows)
    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(rows + 17), 8, 32768,
                                                n_beams=64 if rows == 63 else 32)
    images = range_view_project_batch(torch.from_numpy(pts).to(cuda_device), spec,
                                      torch.from_numpy(valid).to(cuda_device))
    box = [torch.from_numpy(gt[k]).to(cuda_device) for k in ("center", "size", "yaw")]
    halves = [a.reshape(2, 4, *a.shape[1:]) for a in box + [images]]
    before = label_encode.LAUNCHES_DIRECT
    for footprint, yaw_frame in DIRECT_CODECS:
        kw = {"footprint": footprint, "yaw_frame": yaw_frame}
        want = encoding.encode_direct_label_reference(*box, images, spec, **kw)
        assert float(want[..., 1].sum()) > 0, (footprint, yaw_frame)
        assert _same_bits(encoding.encode_direct_label_batch(*box, images, spec, **kw), want)
        assert _same_bits(encoding.encode_direct_label(*(a[3] for a in box), images[3], spec, **kw),
                          want[3])
        assert _same_bits(encoding.encode_direct_label(*halves, spec, **kw),
                          want.reshape(2, 4, *want.shape[1:]))
    for channels in (2, 4):
        img = torch.cat([images, images[..., :1]], -1)[..., :channels].contiguous()
        assert _same_bits(encoding.encode_direct_label(*box, img, spec),
                          encoding.encode_direct_label_reference(*box, img, spec))
    torch.cuda.synchronize()
    assert label_encode.LAUNCHES_DIRECT == before + 3 * len(DIRECT_CODECS) + 2


def test_direct_encode_kernel_rejects_bad_inputs(cuda_device):
    center, size, yaw, image = (torch.from_numpy(a).to(cuda_device)
                                for a in parity_inputs.label_inputs(SPEC, 2))
    before = label_encode.LAUNCHES_DIRECT
    with pytest.raises(ValueError, match="float32"):
        label_encode.encode_direct_label(center, size, yaw, image.double(), SPEC)
    with pytest.raises(ValueError, match="C >= 2"):
        label_encode.encode_direct_label(center, size, yaw, image[..., :1].contiguous(), SPEC)
    with pytest.raises(ValueError, match="C >= 2"):
        label_encode.encode_direct_label(center, size, yaw, image, RangeViewSpec(res_h_deg=1.8))
    with pytest.raises(ValueError, match="contiguous"):
        label_encode.encode_direct_label(center, size, yaw, image[..., :2], SPEC)
    with pytest.raises(ValueError, match="center must have shape"):
        label_encode.encode_direct_label(center[0], size, yaw, image, SPEC)
    with pytest.raises(ValueError, match="yaw must have shape"):
        label_encode.encode_direct_label(center, size, yaw[:1], image, SPEC)
    with pytest.raises(ValueError, match="unknown footprint"):
        label_encode.encode_direct_label(center, size, yaw, image, SPEC, "outer_rect")
    with pytest.raises(ValueError, match="unknown yaw_frame"):
        label_encode.encode_direct_label(center, size, yaw, image, SPEC, "surface", "polar")
    assert label_encode.LAUNCHES_DIRECT == before


@pytest.mark.parametrize("yaw_frame", ["local", "global", "both"])
def test_direct_train_and_eval_steps_launch_the_direct_kernel(cuda_device, yaw_frame):
    """A direct-head train step and eval step on a points batch each encode
    their labels in one launch of the direct kernel, none of the corner
    kernel, and train on the plain version's label."""
    from tpufusion_torch.config import LossConfig, ModelConfig, TrainConfig
    from tpufusion_torch.geometry.encoding import encode_direct_label_reference
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import encode_batch, make_eval_step, make_train_step

    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(7), 4, 8192)
    batch = {"points": pts, "valid": valid, **{k: gt[k] for k in ("center", "size", "yaw")}}
    tensors = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    images, labels = encode_batch(tensors, SPEC, "direct", yaw_frame)
    want = encode_direct_label_reference(*(tensors[k] for k in ("center", "size", "yaw")),
                                         images, SPEC, yaw_frame=yaw_frame)
    assert _same_bits(labels, want)
    model = FCN(ModelConfig(head="direct", yaw_codec="dual" if yaw_frame == "both" else "single"),
                3).to(cuda_device)
    steps = (make_train_step(SPEC, LossConfig(), TrainConfig(batch_size=4, augment=False),
                             head="direct", yaw_frame=yaw_frame, device=cuda_device),
             make_eval_step(SPEC, LossConfig(), head="direct", yaw_frame=yaw_frame,
                            device=cuda_device))
    opt = Adam(model.parameters(), 1e-3)
    for step, args in zip(steps, ((model, opt, tensors), (model, tensors))):
        before = (label_encode.LAUNCHES_DIRECT, label_encode.LAUNCHES)
        loss, _ = step(*args)
        torch.cuda.synchronize()
        assert (label_encode.LAUNCHES_DIRECT, label_encode.LAUNCHES) == (before[0] + 1, before[1])
        assert torch.isfinite(loss)


# the direct decode kernel (csrc/decode_direct.cu) against its plain
# version: tpufusion_torch/_golden.py's DIRECT_KERNEL_* contract


def _tall_spec():
    from tpufusion_torch._golden import TALL_RES_V_DEG

    return RangeViewSpec(res_v_deg=TALL_RES_V_DEG)


@pytest.mark.parametrize("rows", [32, 63])
@pytest.mark.parametrize("channels", [10, 12])
@pytest.mark.parametrize("kind", parity_inputs.CLUSTER_KINDS)
def test_decode_direct_kernel_on_the_adversarial_clusters(cuda_device, kind, channels, rows):
    """Every covered center, boundary and yaw frame at k = 4 on
    `parity_inputs.cluster_inputs`: one launch a call, found equal, poses
    within the contract (a lane within DIRECT_KERNEL_NEAR of a threshold
    counted and exempt)."""
    from tpufusion_torch.ops import decode_direct

    spec = SPEC if rows == 32 else _tall_spec()
    y_pred, images = (torch.from_numpy(a).to(cuda_device) for a in parity_inputs.cluster_inputs(
        spec, kind, batch=4, seed=rows + channels, channels=channels))
    near = 0
    for name, fields in parity_inputs.cluster_decode_options(channels).items():
        r = decode_direct.against_plain(y_pred, images, spec, DecodeConfig(**fields), 4,
                                        adversarial=True)
        near += r["near"]
        print(f"{kind} {channels} ch {rows} rows {name}: {r}")
        assert r["ok"], (name, r)
    print(f"{kind}: lanes near a threshold {near}")


def test_decode_direct_kernel_on_the_assets_outputs(cuda_device):
    """The shipped assets' FCNs on beam scans at 32 and 63 rows, at their
    operating points and DecodeConfig's default, k = 1 and 4: the
    contract, and no lane near a threshold."""
    _assets_against_plain(cuda_device, torch.float32)


def test_decode_direct_kernel_on_bf16_outputs(cuda_device):
    """The same outputs rounded to bf16, read by the kernel's bf16
    instance: the contract, and no lane near a threshold (a bf16 sum near
    a rounding midpoint included)."""
    _assets_against_plain(cuda_device, torch.bfloat16)


def test_decode_direct_kernel_on_float16_outputs(cuda_device):
    """The same outputs rounded to float16, read by the kernel's float16
    instance (each op of two float16 values rounded as the plain version
    rounds it): the contract, and no lane near a threshold."""
    _assets_against_plain(cuda_device, torch.float16)


def _assets_against_plain(cuda_device, dtype):
    from tpufusion_torch.data.synthetic import synthesize_beam_multi_vehicle_batch
    from tpufusion_torch.ops import decode_direct

    for spec, beams in ((SPEC, 32), (_tall_spec(), 64)):
        pts, _, valid = synthesize_beam_multi_vehicle_batch(
            np.random.default_rng(8), 16, 32768, n_vehicles=2, n_beams=beams)
        with torch.inference_mode():
            images = range_view_project_batch(torch.from_numpy(pts).to(cuda_device), spec,
                                              torch.from_numpy(valid).to(cuda_device))
        for name in ("synthetic_detector.npz", "synthetic_detector_yaw.npz",
                     "synthetic_detector_mixed.npz"):
            path = os.path.join(os.path.dirname(ASSET), name)
            mcfg, dcfg = asset_configs(path)
            model = FCN(mcfg)
            load_state_npz(path, model)
            with torch.inference_mode():
                y_pred = model.to(cuda_device).eval()(images).to(dtype)
            cfgs = [dcfg] + ([DecodeConfig()] if name == "synthetic_detector.npz" else [])
            for cfg in cfgs:
                for k in (1, 4):
                    r = decode_direct.against_plain(y_pred, images, spec, cfg, k)
                    print(f"{name} {dtype} {spec.height} rows {cfg.direct_center} k {k}: {r}")
                    assert r["ok"] and r["near"] == 0 and r["found"] > 0, r


def test_decode_batch_direct_launches_the_kernel_once(cuda_device):
    """Every covered center: one decode_direct launch and one CC launch a
    call; "silhouette" none of the decode kernel."""
    from tpufusion_torch.ops import decode_direct

    y_pred, images = (torch.from_numpy(a).to(cuda_device)
                      for a in parity_inputs.cluster_inputs(SPEC, "cars", batch=2, channels=10))
    for center in decode._CENTERS:
        before = (decode_direct.LAUNCHES, cc.LAUNCHES)
        out = decode.decode_batch_direct(y_pred, images, SPEC, DecodeConfig(min_prob=0.8), 4,
                                         center)
        torch.cuda.synchronize()
        want = (before[0] + (center != "silhouette"), before[1] + 1)
        assert (decode_direct.LAUNCHES, cc.LAUNCHES) == want, center
        assert out["poses"].shape == (2, 4, 7) and bool(out["found"].any())


@pytest.mark.parametrize("rows", [32, 63])
@pytest.mark.parametrize("channels", [10, 12])
def test_decode_direct_kernel_on_the_crafted_lanes(cuda_device, channels, rows):
    """`parity_inputs.crafted_lanes`, windows the heat mask never makes: a
    one-pixel window, two rows that straddle the lane's CTAs, a block of
    20 rows x the frame's width (past every CTA's stage and the first
    design's 4,096-point list), a car with a hole, clusters with no m or
    no return; every covered center, boundary (all 37 headings, the auto
    arms) and yaw frame: the contract, and two calls bit-identical."""
    from tpufusion_torch.ops import decode_direct

    spec = SPEC if rows == 32 else _tall_spec()
    y_pred, images, *comps, root, found = (
        torch.from_numpy(a).to(cuda_device)
        for a in parity_inputs.crafted_lanes(spec, batch=4, seed=rows, channels=channels))
    for name, fields in parity_inputs.cluster_decode_options(channels).items():
        r = decode_direct.lanes_against_plain(y_pred, images, comps, root, found, spec,
                                              DecodeConfig(**fields), adversarial=True)
        print(f"crafted {channels} ch {rows} rows {name}: {r}")
        assert r["ok"] and r["repeatable"] and r["found"] > 0, (name, r)
        assert r["windows"] == 20 * spec.width, r


def test_decode_direct_kernel_is_bit_identical_call_to_call(cuda_device):
    """The sums run in a fixed order (a thread's terms, its warp's tree,
    the warps, the cluster's CTAs by rank), so a call gives the same bits
    every time: the live asset on 64 beam-scan frames and the whole-frame
    clusters, 10 calls each."""
    from tpufusion_torch.benchmarks import asset_model, point_sets
    from tpufusion_torch.ops import decode_direct

    model, dcfg, _ = asset_model(ASSET)
    (p, v), = point_sets(1, 64, 32768, cuda_device, seed0=77)
    whole = [torch.from_numpy(a).to(cuda_device)
             for a in parity_inputs.cluster_inputs(SPEC, "whole", batch=4, channels=10)]
    with torch.inference_mode():
        images = range_view_project_batch(p, SPEC, v)
        cases = [(model.to(cuda_device).eval()(images), images, dcfg),
                 (*whole, DecodeConfig(**parity_inputs.cluster_decode_options(10)[
                     "fit_ellipse_local"]))]
        for y_pred, im, cfg in cases:
            comps = decode._heat_components(y_pred[..., 1], cfg)
            root, found, *_ = decode._topk_roots(*comps, cfg, 4)
            outs = [decode_direct.decode_direct_clusters(y_pred, im, *comps, root, found, SPEC,
                                                         cfg, cfg.direct_center)
                    for _ in range(10)]
            assert bool(outs[0][1].any())
            for p_, f_ in outs[1:]:
                assert torch.equal(p_.view(torch.int32), outs[0][0].view(torch.int32))
                assert torch.equal(f_, outs[0][1])


def test_decode_direct_kernel_raises_when_the_build_fails(cuda_device, monkeypatch, tmp_path):
    """No fallback: a library that cannot be built makes the wrapper raise."""
    from tpufusion_torch import _build
    from tpufusion_torch.ops import decode_direct

    def fail(_out):
        raise RuntimeError("nvcc failed (test)")

    y_pred, images = (torch.from_numpy(a).to(cuda_device)
                      for a in parity_inputs.cluster_inputs(SPEC, "cars", batch=1, channels=10))
    cfg = DecodeConfig(min_prob=0.8)
    comps = decode._heat_components(y_pred[..., 1], cfg)  # the CC kernel, built
    root, found, *_ = decode._topk_roots(*comps, cfg, 2)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "missing.so"))
    monkeypatch.setattr(_build, "_compile", fail)
    before = decode_direct.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        decode_direct.decode_direct_clusters(y_pred, images, *comps, root, found, SPEC, cfg,
                                             "backproject")
    assert decode_direct.LAUNCHES == before


def test_decode_direct_kernel_rejects_bad_inputs(cuda_device):
    from tpufusion_torch.ops import decode_direct

    y_pred, images = (torch.from_numpy(a).to(cuda_device)
                      for a in parity_inputs.cluster_inputs(SPEC, "cars", batch=1, channels=10))
    cfg = DecodeConfig(min_prob=0.8)
    comps = decode._heat_components(y_pred[..., 1], cfg)
    root, found, *_ = decode._topk_roots(*comps, cfg, 2)
    before = decode_direct.LAUNCHES
    run = decode_direct.decode_direct_clusters
    with pytest.raises(ValueError, match="dual-codec"):
        run(y_pred, images, *comps, root, found, SPEC, dataclasses.replace(
            cfg, direct_yaw_frame="auto"), "backproject")
    with pytest.raises(ValueError, match="unknown fit_boundary"):
        run(y_pred, images, *comps, root, found, SPEC, dataclasses.replace(
            cfg, fit_boundary="polygon"), "fit")
    with pytest.raises(ValueError, match="root must be"):
        run(y_pred, images, *comps, root.int(), found, SPEC, cfg, "backproject")
    with pytest.raises(ValueError, match="y_pred must be"):  # float16 is a type it reads
        run(y_pred.double(), images, *comps, root, found, SPEC, cfg, "backproject")
    with pytest.raises(ValueError, match="silhouette"):
        run(y_pred, images, *comps, root, found, SPEC, cfg, "silhouette")
    assert decode_direct.LAUNCHES == before


def test_decode_batch_direct_launches_the_kernel_once_on_a_bf16_output(cuda_device,
                                                                       monkeypatch):
    """A bf16 CUDA y_pred: every covered center one decode_direct launch a
    call (the C entry's count), the wrapper handed the caller's bf16
    tensor itself (no float32 copy), the plain version never called;
    "silhouette" runs the plain version, as for float32."""
    _launches_once(cuda_device, monkeypatch, torch.bfloat16)


def test_decode_batch_direct_launches_the_kernel_once_on_a_float16_output(cuda_device,
                                                                          monkeypatch):
    """The same for a float16 CUDA y_pred: the kernel's float16 instance,
    never the plain version (no fallback), no float32 copy."""
    _launches_once(cuda_device, monkeypatch, torch.float16)


def _launches_once(cuda_device, monkeypatch, dtype):
    from tpufusion_torch.ops import decode_direct

    y_pred, images = (torch.from_numpy(a).to(cuda_device)
                      for a in parity_inputs.cluster_inputs(SPEC, "cars", batch=2, channels=10))
    y_pred = y_pred.to(dtype)
    handed = []
    wrapper, plain = decode_direct.decode_direct_clusters, decode.decode_direct_clusters_reference

    def only_silhouette(*a, **kw):
        assert a[-1] == "silhouette", f"the plain version ran for {a[-1]}"
        return plain(*a, **kw)

    monkeypatch.setattr(decode, "decode_direct_clusters",
                        lambda *a: handed.append((a[0].dtype, a[0].data_ptr())) or wrapper(*a))
    monkeypatch.setattr(decode, "decode_direct_clusters_reference", only_silhouette)
    for center in decode._CENTERS:
        before = decode_direct.LAUNCHES
        out = decode.decode_batch_direct(y_pred, images, SPEC, DecodeConfig(min_prob=0.8), 4,
                                         center)
        torch.cuda.synchronize()
        assert decode_direct.LAUNCHES == before + (center != "silhouette"), center
        assert out["poses"].dtype == torch.float32 and out["poses"].shape == (2, 4, 7)
        assert bool(out["found"].any()), center
    assert handed == [(dtype, y_pred.data_ptr())] * (len(decode._CENTERS) - 1)


def test_decode_direct_kernel_counts_a_bf16_probability_at_the_threshold(cuda_device):
    """`parity_inputs.threshold_inputs`: a pixel of exactly bf16(0.7) at
    min_prob 0.7 counts (frame 0) where one bf16 step below it does not
    (frame 1), in the kernel as in its plain version; every covered center,
    boundary and yaw frame of a 10-channel head."""
    _threshold_counts(cuda_device, "bfloat16")


def test_decode_direct_kernel_counts_a_float16_probability_at_the_threshold(cuda_device):
    """The same in float16: a pixel of exactly float16(0.8) at min_prob 0.8
    counts where one float16 step below it does not."""
    _threshold_counts(cuda_device, "float16")


def _threshold_counts(cuda_device, dtype):
    from tpufusion_torch.ops import decode_direct

    min_prob = parity_inputs.THRESHOLDS[dtype][0]
    y, images, _ = parity_inputs.threshold_inputs(SPEC, dtype=dtype)
    y_pred = torch.from_numpy(y).to(cuda_device).to(getattr(torch, dtype))
    images = torch.from_numpy(images).to(cuda_device)
    for name, fields in parity_inputs.cluster_decode_options(10).items():
        cfg = DecodeConfig(**dict(fields, min_prob=min_prob))
        r = decode_direct.against_plain(y_pred, images, SPEC, cfg, 4)
        print(f"{dtype} threshold {name}: {r}")
        assert r["ok"] and r["near"] == 0 and r["found"] > 0, (name, r)
        poses = decode.decode_batch_direct(y_pred, images, SPEC, cfg, 4)["poses"]
        assert not torch.equal(poses[0], poses[1]), f"{name}: the pixel at the threshold did not count"


def test_decode_direct_float16_kernel_matches_the_f16_golden(cuda_device):
    """decode_batch_direct on the float16 golden's outputs (the two assets'
    FCN outputs rounded to float16) at every kernel center and silhouette,
    k 2 and k 1: found equal and poses within 1e-4 of JAX's answers; the
    kernel against its plain version on the same lanes (the contract, no
    lane near a threshold)."""
    from tpufusion_torch._golden import (
        F16_DECODE_CASES,
        F16_DECODE_K,
        bf16_decode_case,
        from_f16_bits,
    )
    from tpufusion_torch.ops import decode_direct

    gb, gf = load_npz(GOLDEN_BF16), load_npz(GOLDEN_F16)
    images = torch.from_numpy(gb["images"]).to(cuda_device)
    ys = {fcn: torch.from_numpy(from_f16_bits(gf[f"{fcn}_bits"])).to(cuda_device).half()
          for fcn in ("asset", "mixed")}
    assets = os.path.join(_REPO, "tpufusion", "assets")
    for name in sorted(F16_DECODE_CASES):
        fcn, cfg = bf16_decode_case(name, assets, F16_DECODE_CASES)
        for k, tag in ((F16_DECODE_K, name), (1, f"{name}_k1")):
            before = decode_direct.LAUNCHES
            got = decode.decode_batch_direct(ys[fcn], images, SPEC, cfg, k)
            torch.cuda.synchronize()
            assert decode_direct.LAUNCHES == before + (cfg.direct_center != "silhouette")
            np.testing.assert_array_equal(got["found"].cpu().numpy(), gf[f"{tag}_found"])
            assert _pose_diff(got["poses"].cpu().numpy(), gf[f"{tag}_poses"]) <= 1e-4, tag
        if cfg.direct_center != "silhouette":
            r = decode_direct.against_plain(ys[fcn], images, SPEC, cfg, F16_DECODE_K)
            assert r["ok"] and r["near"] == 0 and r["found"] > 0, (name, r)


def test_corner_decode_on_a_float16_output_matches_the_cpu(cuda_device):
    """The corner paths on a float16 head: decode_batch and
    decode_batch_multi on the card (the positives compared in float16, the
    vote kernel reading a float32 copy) against the plain version on the
    CPU, on the label-encoded corner outputs rounded to float16."""
    from tpufusion_torch.ops import corner_vote

    g = load_npz(GOLDEN_MULTI)
    images = range_view_project_batch(torch.from_numpy(g["multi_points"][:2]), SPEC,
                                      torch.from_numpy(g["multi_valid"][:2]))
    y = torch.from_numpy(g["corner_ypred"]).half()
    for fn, args in ((decode.decode_batch, ()), (decode.decode_batch_multi, (4,))):
        before = corner_vote.LAUNCHES
        got = fn(y.to(cuda_device), images.to(cuda_device), SPEC, DecodeConfig(), *args)
        torch.cuda.synchronize()
        assert corner_vote.LAUNCHES > before
        want = fn(y, images, SPEC, DecodeConfig(), *args)
        for key, w in want.items():
            gk = got[key].cpu()
            assert gk.dtype == w.dtype, (key, gk.dtype, w.dtype)
            if w.is_floating_point():
                assert float((gk - w).abs().max()) <= 1e-4, (fn.__name__, key)
            else:
                assert torch.equal(gk, w), (fn.__name__, key)
        assert bool(want["found"].any())


# the corner vote kernel (csrc/corner_vote.cu) against its plain version:
# tpufusion_torch/_golden.py's CORNER_KERNEL_* contract


@pytest.mark.parametrize("frames, rows", [(64, 32), (16, 32), (64, 63)])
@pytest.mark.parametrize("kind", parity_inputs.CORNER_KINDS)
def test_corner_vote_kernel_on_the_corner_inputs(cuda_device, kind, frames, rows):
    """Every `parity_inputs.corner_inputs` kind at K 64 and 2048: one launch
    a call, ok and overflow equal on the voted lanes, zeros on the others,
    and on the decided lanes the winner sets equal and pose and box within
    1e-4 (undecided lanes counted)."""
    from tpufusion_torch.ops import corner_vote

    spec = SPEC if rows == 32 else _tall_spec()
    arrays = parity_inputs.corner_inputs(spec, kind, batch=frames, seed=rows + frames)
    y, images, bbox, c3, lanes = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    for k in (64, 2048):
        r = corner_vote.against_plain(y, images, bbox, c3, lanes, spec,
                                      DecodeConfig(max_candidates=k))
        print(f"{kind} {frames} x {rows} rows K {k}: {r}")
        assert r["ok"], r


@pytest.mark.parametrize("shape", range(5))
def test_corner_vote_kernel_on_the_corner_paths(cuda_device, shape):
    """The lanes the corner paths vote (`kernel_bench.CORNER_SHAPES`: the
    corner row's seeded FCN at 64 x 32 x 1801, the corner head on the
    asset's trunk at 64 frames k 1, 16 frames k 4 and 63 rows, every pixel
    positive): the contract; no undecided lane but where every pixel is a
    candidate."""
    from tpufusion_torch.kernel_bench import CORNER_SHAPES, corner_vote_inputs
    from tpufusion_torch.ops import corner_vote

    spec, cfg, sets = corner_vote_inputs(cuda_device, CORNER_SHAPES[shape], 1)
    r = corner_vote.against_plain(*sets[0][:4], sets[0][4], spec, cfg)
    print(f"{CORNER_SHAPES[shape][0]}: {r}")
    assert r["ok"], r
    assert r["undecided"] == 0 or CORNER_SHAPES[shape][-1] == "full", r


def test_corner_decode_launches_the_vote_once_without_a_gram_tensor(cuda_device):
    """decode_batch, decode_batch_multi, corner_vote and a corner
    make_e2e_step each launch the vote once, and none allocates a (B, n,
    K, K) array: at 16 frames the vote's peak above its inputs stays under
    one lane's K x K float32 (16 MiB), each decode's under a quarter of
    its lanes' (B, n, K, K) float32 (the back-projection's (B, n, H, W)
    temporaries are in it)."""
    from tpufusion_torch.kernel_bench import corner_fcn
    from tpufusion_torch.ops import corner_vote

    model, dcfg = corner_fcn("hybrid", cuda_device)
    pts, _, valid = synthesize_beam_scan_batch(np.random.default_rng(5), 16, 32768)
    pts, valid = torch.from_numpy(pts).to(cuda_device), torch.from_numpy(valid).to(cuda_device)
    with torch.inference_mode():
        images = range_view_project_batch(pts, SPEC, valid)
        y = model(images)
        bbox, c3, _ = corner_vote.corner_lanes(y, images, SPEC, dcfg, 4)
    step = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head="corner", device=cuda_device)
    gram = 2048 * 2048 * 4
    calls = {
        "decode_batch": (lambda: decode.decode_batch(y, images, SPEC, dcfg), 16 * gram // 4),
        "decode_batch_multi": (lambda: decode.decode_batch_multi(y, images, SPEC, dcfg, 4),
                               64 * gram // 4),
        "corner_vote": (lambda: decode.corner_vote(y, images, bbox, c3, SPEC, dcfg), gram),
        "make_e2e_step": (lambda: step(pts, valid), None),  # its range view and maps too
    }
    for name, (fn, limit) in calls.items():
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = corner_vote.LAUNCHES
            fn()
            torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        print(f"{name}: {extra / 2**20:.1f} MiB above its inputs")
        assert corner_vote.LAUNCHES == before + 1, name
        assert limit is None or extra < limit, (name, extra)


@pytest.mark.parametrize("kind", ["ties", "budget", "random"])
def test_corner_vote_kernel_skips_frames_that_vote_no_lane(cuda_device, kind):
    """Frames whose lanes all stay out beside frames that vote: the
    contract on the voted lanes, zeros and False on the others, two calls
    bit-identical; the skipped frames' y_pred and map are never read (NaN
    and every pixel positive there change nothing)."""
    from tpufusion_torch.decode.decode import _positives
    from tpufusion_torch.ops import corner_vote

    arrays = parity_inputs.corner_inputs(SPEC, kind, batch=8, seed=11)
    y, images, bbox, c3, lanes = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    lanes[1::2] = False
    cfg = DecodeConfig()
    r = corner_vote.against_plain(y, images, bbox, c3, lanes, SPEC, cfg)
    print(f"{kind}: {r}")
    assert r["ok"] and r["zeros"] and r["repeatable"], r
    with torch.inference_mode():
        pos = _positives(y[..., 1], cfg)
        want = corner_vote.corner_vote_lanes(y, images, bbox, c3, lanes, SPEC, cfg, pos)
        y_bad, pos_bad = y.clone(), pos.clone()
        y_bad[1::2], pos_bad[1::2] = float("nan"), True
        got = corner_vote.corner_vote_lanes(y_bad, images, bbox, c3, lanes, SPEC, cfg, pos_bad)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))


def test_corner_vote_makes_at_most_two_device_launches(cuda_device):
    """One call of the wrapper, handed a float32 output, its positives map
    and the lanes as the decode hands them, launches two kernels on the
    card (the lists, and the counts with the winners; the C entry counts
    its launches) and no torch kernel; on the corner row's inputs, where
    no lane votes, too. (torch.profiler loses device records late in a
    long process, so the entry's own count is read.)"""
    from tpufusion_torch.kernel_bench import CORNER_SHAPES, corner_vote_inputs
    from tpufusion_torch.ops import corner_vote

    for shape in (CORNER_SHAPES[0], CORNER_SHAPES[1]):
        spec, cfg, sets = corner_vote_inputs(cuda_device, shape, 1)
        y, im, bbox, c3, lanes, pos = sets[0]
        y = y.float().contiguous()
        with torch.inference_mode():
            corner_vote.corner_vote_lanes(y, im, bbox, c3, lanes, spec, cfg, pos)  # warm
            torch.cuda.synchronize()
            computing = []  # torch ops that made new data (an allocation or an alias makes none)

            class Ops(torch.utils._python_dispatch.TorchDispatchMode):
                def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                    out = func(*args, **(kwargs or {}))
                    ins = {a.data_ptr() for a in args if isinstance(a, torch.Tensor)}
                    if "empty" not in str(func) and not (
                            isinstance(out, torch.Tensor) and out.data_ptr() in ins):
                        computing.append(str(func))
                    return out

            before = corner_vote.kernel_launches()
            with Ops():
                corner_vote.corner_vote_lanes(y, im, bbox, c3, lanes, spec, cfg, pos)
            torch.cuda.synchronize()
            kernels = corner_vote.kernel_launches() - before
        print(f"{shape[0]}: {kernels} kernels, torch ops that computed {computing}")
        assert kernels == 2, kernels
        assert not computing, computing


def test_corner_vote_kernel_raises_when_the_build_fails(cuda_device, monkeypatch, tmp_path):
    """No fallback: a library that cannot be built makes the wrapper raise."""
    from tpufusion_torch import _build
    from tpufusion_torch.ops import corner_vote

    def fail(_out):
        raise RuntimeError("nvcc failed (test)")

    arrays = parity_inputs.corner_inputs(SPEC, "ties", batch=1)
    y, images, bbox, c3, lanes = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "missing.so"))
    monkeypatch.setattr(_build, "_compile", fail)
    before = corner_vote.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        corner_vote.corner_vote_lanes(y, images, bbox, c3, lanes, SPEC, DecodeConfig())
    assert corner_vote.LAUNCHES == before


def test_corner_vote_kernel_rejects_bad_inputs(cuda_device):
    from tpufusion_torch.ops import corner_vote

    arrays = parity_inputs.corner_inputs(SPEC, "ties", batch=1)
    y, images, bbox, c3, lanes = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    run = corner_vote.corner_vote_lanes
    before = corner_vote.LAUNCHES
    with pytest.raises(ValueError, match="C >= 26"):
        run(y[..., :10], images, bbox, c3, lanes, SPEC, DecodeConfig())
    with pytest.raises(ValueError, match="float tensor"):
        run(y.int(), images, bbox, c3, lanes, SPEC, DecodeConfig())
    with pytest.raises(ValueError, match="integer"):
        run(y, images, bbox.float(), c3, lanes, SPEC, DecodeConfig())
    with pytest.raises(ValueError, match="centroid_3d must be"):
        run(y, images, bbox, c3.double(), lanes, SPEC, DecodeConfig())
    with pytest.raises(ValueError, match="lanes must be"):
        run(y, images, bbox, c3, lanes.int(), SPEC, DecodeConfig())
    with pytest.raises(ValueError, match="spec's"):
        run(y, images, bbox, c3, lanes, _tall_spec(), DecodeConfig())
    assert corner_vote.LAUNCHES == before
    pose, box, ok, over = run(y.to(torch.bfloat16), images, bbox, c3, lanes, SPEC,
                              DecodeConfig())  # converted to float32, as the plain version reads it
    assert corner_vote.LAUNCHES == before + 1 and bool(ok.any())


GOLDEN_F8 = os.path.join(_REPO, "tests", "data", "torch_port_golden_f8.npz")


def _small_float_sets():
    from tpufusion_torch.ops import small_float as sf

    patterns, values = parity_inputs.small_float_inputs(seed=23)
    halves = torch.from_numpy(patterns.view(np.float16))
    return sf, {"float16 patterns": halves, "float16 patterns as float32": halves.float(),
                "float32 values": torch.from_numpy(values)}


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e3m4", "float8_e4m3",
                                  "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
                                  "float8_e8m0fnu", "float4_e2m1fn"])
def test_small_float_kernel_matches_its_plain_version(cuda_device, name):
    """Both modes of csrc/small_float.cu against the plain version run on
    the CPU, bit for bit (a NaN's sign included): the direct cast into
    float32, the carrier and the codes, and
    the epilogue with and without relu on edge and seeded biases, on every
    float16 pattern and on float32 values with the formats' edges; one
    launch a call."""
    sf, sets = _small_float_sets()
    fmt = sf.FORMATS[name]
    outs = (torch.float32, torch.uint8) + ((torch.float16,) if fmt.via_f16 else ())
    biases = [torch.tensor([0.0, -0.0, float("inf"), float("nan"), 448.0, 1e-3, -2.5, 3.4e38]),
              torch.from_numpy(np.random.default_rng(5).normal(0, 1, 8).astype(np.float32))]
    for label, x in sets.items():
        for out in outs:
            before = sf.LAUNCHES
            got = sf.cast(x.to(cuda_device), fmt, out)
            assert sf.LAUNCHES == before + 1
            assert sf.same_bits(got.cpu(), sf.cast_reference(x, fmt, out)), (label, out)
        y = x[: x.numel() // 16 * 16].view(2, 8, -1, 1)
        for b in biases:
            for relu in (False, True):
                for out in outs[:1] + outs[2:]:
                    got = sf.conv_epilogue(y.to(cuda_device), b.to(cuda_device), fmt, relu,
                                           out=out)
                    want = sf.conv_epilogue_reference(y, b, fmt, relu, out=out)
                    assert sf.same_bits(got.cpu(), want), (label, relu, out)


def test_small_float_fcn_matches_the_f8_golden_and_its_float32_convolutions(cuda_device):
    """The asset's FCN in float8_e4m3fn on the f8 golden's frames: at least
    F8_FEATURES_SAME of the sampled feature codes JAX's and the
    probabilities within 1e-6; every epilogue at those shapes equal to the
    plain version on the card; float16 convolutions (fcn.SMALL_FLOAT_CONV)
    equal to float32 ones rounded to float16, layer by layer."""
    from tpufusion_torch._golden import (
        F8_FEATURES_SAME,
        F8_FRAMES,
        small_float_readings,
        small_float_sample,
    )
    from tpufusion_torch.kernel_bench import recorded_epilogues
    from tpufusion_torch.models import fcn
    from tpufusion_torch.ops import small_float as sf

    gm, g8 = load_npz(GOLDEN_MULTI), load_npz(GOLDEN_F8)
    mcfg, _ = asset_configs(ASSET)
    model = FCN(dataclasses.replace(mcfg, dtype="float8_e4m3fn"))
    load_state_npz(ASSET, model)
    model = model.to(cuda_device).eval()
    inputs, layers = [], []
    hooks = [m.register_forward_pre_hook(lambda m, a: inputs.append((m, a[0])))
             for m in model.modules() if isinstance(m, fcn._Layer)]
    with torch.inference_mode(), recorded_epilogues(layers):
        images = range_view_project_batch(
            torch.from_numpy(gm["multi_points"][:F8_FRAMES]).to(cuda_device), SPEC,
            torch.from_numpy(gm["multi_valid"][:F8_FRAMES]).to(cuda_device))
        out = model(images)
        codes = model.features(images).view(torch.uint8)
    for h in hooks:
        h.remove()
    same, dp, nan_ok = small_float_readings(
        *small_float_sample(codes.cpu().numpy(), out.cpu().numpy()),
        g8["float8_e4m3fn_features"], g8["float8_e4m3fn_prob"])
    assert same >= F8_FEATURES_SAME and dp <= 1e-6 and nan_ok, (same, dp)
    with torch.inference_mode():
        for (m, x), (y, b, relu) in zip(inputs, layers):
            assert sf.same_bits(sf.conv_epilogue(y, b, model.fmt, relu, out=y.dtype),
                                sf.conv_epilogue_reference(y, b, model.fmt, relu, out=y.dtype))
            assert sf.same_bits(m.raw(x.half()), m.raw(x.float()).half())


def test_small_float_e2e_step_launches_the_epilogue_a_layer(cuda_device):
    """make_e2e_step with the asset in float8_e4m3fn: 17 small-float
    launches its first step (the input, 8 kernels, 8 epilogues) and 9 a
    step after it (the kernels' casts kept), found and poses as JAX's on
    the f8 golden's frames (top-4)."""
    from tpufusion_torch._golden import F8_E2E_K
    from tpufusion_torch.ops import small_float as sf

    gm, g8 = load_npz(GOLDEN_MULTI), load_npz(GOLDEN_F8)
    mcfg, dcfg = asset_configs(ASSET)
    model = FCN(dataclasses.replace(mcfg, dtype="float8_e4m3fn"))
    load_state_npz(ASSET, model)
    step = make_e2e_step(model, SPEC, dcfg, max_obstacles=F8_E2E_K, head="direct",
                         device=cuda_device)
    before = sf.LAUNCHES
    step(gm["multi_points"], gm["multi_valid"])
    assert sf.LAUNCHES == before + 17
    poses, found = step(gm["multi_points"], gm["multi_valid"])
    assert sf.LAUNCHES == before + 17 + 9
    want = g8["e2e_float8_e4m3fn_found"]
    np.testing.assert_array_equal(found.cpu().numpy(), want)
    assert wrapped_pose_diff(poses.cpu().numpy(), g8["e2e_float8_e4m3fn_poses"])[want].max() \
        < POSE_TOL


def test_small_float_kernel_raises_when_the_build_fails(cuda_device, monkeypatch, tmp_path):
    """No fallback: a library that cannot be built makes both wrappers raise."""
    from tpufusion_torch import _build
    from tpufusion_torch.ops import small_float as sf

    def fail(_out):
        raise RuntimeError("nvcc failed (test)")

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: str(tmp_path / "missing.so"))
    monkeypatch.setattr(_build, "_compile", fail)
    fmt = sf.FORMATS["float8_e4m3fn"]
    y = torch.ones(1, 2, 3, 4, device=cuda_device)
    before = sf.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sf.cast(y, fmt)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sf.conv_epilogue(y, torch.zeros(2, device=cuda_device), fmt)
    assert sf.LAUNCHES == before


def test_small_float_kernel_rejects_bad_inputs(cuda_device):
    from tpufusion_torch.ops import small_float as sf

    fmt = sf.FORMATS["float8_e4m3fn"]
    y = torch.ones(1, 2, 3, 4, device=cuda_device)
    with pytest.raises(ValueError, match="float32 or float16"):
        sf.cast(y.double(), fmt)
    with pytest.raises(ValueError, match="bias"):
        sf.conv_epilogue(y, torch.zeros(3, device=cuda_device), fmt)
    with pytest.raises(ValueError, match="cannot be written"):
        sf.conv_epilogue(y, torch.zeros(2, device=cuda_device), sf.FORMATS["float8_e8m0fnu"],
                         out=torch.float16)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e3m4", "float8_e4m3",
                                  "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
                                  "float8_e8m0fnu", "float4_e2m1fn"])
def test_small_float_backward_kernel_matches_its_plain_version(cuda_device, name):
    """The backward of csrc/small_float.cu (`tf_small_float_backward`)
    against its plain version run on the CPU, bit for bit, the bias
    gradient included: `parity_inputs.small_float_backward_cases` (one to
    three cotangents, float16 and float32, a strided view, with and
    without relu; every float16 pattern, the formats' edges, +-0 and NaNs
    of both signs) at each of SMALL_FLOAT_BACKWARD_SHAPES (windows with
    padding, over the batch, a second level), into each output; one
    launch a call."""
    from tpufusion_torch.ops import small_float as sf

    fmt = sf.FORMATS[name]
    outs = (torch.float32,) + ((torch.float16,) if fmt.via_f16 else ())
    for shape in parity_inputs.SMALL_FLOAT_BACKWARD_SHAPES:
        for label, grads, saved, relu in parity_inputs.small_float_backward_cases(
                shape, cuda_device):
            for out in outs:
                before = sf.BACKWARD_LAUNCHES
                got, want, same = sf.backward_against_plain(grads, saved, fmt, relu, out)
                assert sf.BACKWARD_LAUNCHES == before + 1
                assert same, (shape, label, out, got[1], want[1])


def test_small_float_round_grad_matches_its_plain_version(cuda_device):
    """The backward's no-bias mode (`round_grad`: a dgrad's or wgrad's
    fmt(h(g))) on every float16 pattern and the float32 edges, into
    float32 and the carrier, bit for bit its plain version."""
    from tpufusion_torch.ops import small_float as sf

    patterns, values = parity_inputs.small_float_inputs(seed=29)
    xs = [torch.from_numpy(a).view(1, 1, 1, -1) for a in (patterns.view(np.float16), values)]
    for fmt in sf.FORMATS.values():
        for x in xs:
            for out in (torch.float32,) + ((torch.float16,) if fmt.via_f16 else ()):
                got = sf.round_grad(x.to(cuda_device), fmt, out).cpu()
                want = sf.round_grad(x, fmt, out)
                assert sf.same_bits(got, want), (fmt.name, x.dtype, out)


def test_small_float_train_step_launches_the_backward_a_layer(cuda_device):
    """A float8_e4m3fn train step of the asset's geometry without its
    input norm on the card (seeded weights, batch 2 at 32 x 201, a
    foreground box): the backward kernel launches once a layer and once a
    kernel (8 epilogues, 8 roundings; BACKWARD_LAUNCHES; the input takes
    no gradient without the norm), the direct cast once an output
    (LAUNCHES), and at
    least 99 % of each layer's gradient equal to the CPU's step, NaN
    where it is (the card's float32 dgrad and wgrad sum in cuDNN's order,
    a rare value at a midpoint of the format rounds the other way)."""
    from tpufusion_torch.config import LossConfig
    from tpufusion_torch.models.losses import weighted_pose_loss
    from tpufusion_torch.ops import small_float as sf

    mcfg, _ = asset_configs(ASSET)
    mcfg = dataclasses.replace(mcfg, dtype="float8_e4m3fn", batch_norm=False)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0, 20, (2, 32, 201, 3)).astype(np.float32))
    fg = np.zeros((2, 32, 201), bool)
    fg[:, 13:19, 60:90] = True
    reg = rng.uniform(-1, 1, (2, 32, 201, 8)) * fg[..., None]
    labels = torch.from_numpy(np.concatenate([np.eye(2)[fg.astype(int)], reg], -1)
                              .astype(np.float32))
    state = FCN(mcfg, seed=3).state_dict()
    grads = {}
    for dev in ("cpu", cuda_device):
        model = FCN(mcfg)
        model.load_state_dict(state)
        model.to(dev)
        loss = weighted_pose_loss(model(x.to(dev), train=True), labels.to(dev),
                                  LossConfig(weight_bb=1.0))
        before, casts = sf.BACKWARD_LAUNCHES, sf.LAUNCHES
        loss.backward()
        if dev != "cpu":  # 8 epilogues and 8 kernels' rounding; the outputs' casts
            assert (sf.BACKWARD_LAUNCHES - before, sf.LAUNCHES - casts) == (16, 2)
        grads[str(dev)] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    for k, want in grads["cpu"].items():
        got = grads[str(cuda_device)][k]
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        assert float(same.float().mean()) >= 0.99, k


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e3m4", "float8_e4m3",
                                  "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
                                  "float8_e8m0fnu", "float4_e2m1fn"])
def test_small_float_cast_vectors_match_their_plain_version(cuda_device, name):
    """The direct cast (csrc/small_float.cu `cast_kernel`: Hopper's
    conversion for float8_e4m3fn and float8_e5m2, the integer encode for
    the rest) on float32 values at and around the two formats' overflow
    midpoints (464, 61440), both signs, infinities and NaNs, at lengths
    that leave a tail (n % 16) and from views 4 and 2 bytes off 16-byte
    alignment (the scalar path), over several tiles, float32 and float16
    in, and NHWC tensors in NCHW's shape (the FCN's input: the tiled
    transpose, with whole 16-byte vectors where H W is a multiple of 16
    and element by element where it is not), into every output: bit for
    bit the plain version."""
    from tpufusion_torch.ops import small_float as sf

    fmt = sf.FORMATS[name]
    edges = np.array([464.0, 61440.0, 448.0, 57344.0, 480.0, 65536.0, np.inf, np.nan, 0.0,
                      1e-40, 2.0**-10, 2.0**-17], np.float32)
    edges = np.concatenate([edges, np.nextafter(edges, np.float32(np.inf)),
                            np.nextafter(edges, np.float32(0))])
    x = np.concatenate([edges, -edges, np.random.default_rng(9).standard_normal(1003)
                        .astype(np.float32) * 100]).astype(np.float32)
    xs = torch.from_numpy(x)
    outs = (torch.float32, torch.uint8) + ((torch.float16,) if fmt.via_f16 else ())
    nhwc = xs[:2 * 4 * 41 * 3].view(2, 4, 41, 3).permute(0, 3, 1, 2)  # H W = 164
    tiles = torch.from_numpy(np.resize(x, 3 * 4096 + 5))
    wide = tiles[:2 * 32 * 64 * 3].view(2, 32, 64, 3).permute(0, 3, 1, 2)  # H W = 2048
    for label, t in {"float32": xs, "float32 + 1 element": xs[1:], "float16": xs.half(),
                     "float16 + 1 element": xs.half()[1:], "tail": xs[:1003],
                     "several tiles": tiles, "NHWC in memory": nhwc,
                     "NHWC cropped": nhwc[..., :37], "NHWC float16": nhwc.half(),
                     "NHWC, whole vectors": wide, "NHWC float16, whole vectors": wide.half()
                     }.items():
        for out in outs:
            got = sf.cast(t.to(cuda_device), fmt, out).cpu()
            assert sf.same_bits(got, sf.cast_reference(t, fmt, out)), (label, out)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e3m4", "float8_e4m3",
                                  "float8_e4m3fnuz", "float8_e5m2fnuz", "float8_e4m3b11fnuz",
                                  "float8_e8m0fnu", "float4_e2m1fn"])
def test_small_float_bias_grad_kernel_matches_its_plain_version(cuda_device, name):
    """The bias gradient's reduce alone (`tf_small_float_bias_grad`, the
    segments' maps composed) on `parity_inputs.small_float_reduce_inputs`
    (NaN, +-inf, overflowing sums, subnormals, zeros it skips, every code)
    at each of SMALL_FLOAT_REDUCE_SHAPES, contiguous and as a strided
    view, in float32 and the carrier: bit for bit the plain version, a
    NaN where float8_e8m0fnu starts (fmt(0)); one launch a call."""
    from tpufusion_torch.ops import small_float as sf

    fmt = sf.FORMATS[name]
    for shape in parity_inputs.SMALL_FLOAT_REDUCE_SHAPES:
        x = torch.from_numpy(parity_inputs.small_float_reduce_inputs(fmt, shape))
        wide = torch.zeros(shape[0], shape[1], shape[2], 2 * shape[3])
        wide[..., ::2] = x
        for dtype in (torch.float32, fmt.carrier):
            for label, t in {"contiguous": x.to(dtype), "strided": wide.to(dtype)[..., ::2]}.items():
                want = sf.bias_grad_reference(t, fmt)
                before = sf.BACKWARD_LAUNCHES
                got = sf.bias_grad(t.to(cuda_device), fmt).cpu()
                assert sf.BACKWARD_LAUNCHES == before + 1
                assert sf.same_bits(got, want), (shape, dtype, label, got, want)
    if name == "float8_e8m0fnu":
        assert bool(torch.isnan(want).all())


def test_small_float_backward_rejects_bad_inputs(cuda_device):
    from tpufusion_torch.ops import small_float as sf

    fmt = sf.FORMATS["float8_e4m3fn"]
    g = torch.ones(1, 2, 3, 4, device=cuda_device)
    with pytest.raises(ValueError, match="1 to 3"):
        sf.conv_epilogue_backward([g] * 4, None, fmt, False)
    with pytest.raises(ValueError, match="one"):
        sf.conv_epilogue_backward([g, g[:, :1]], None, fmt, False)
    with pytest.raises(ValueError, match="relu"):
        sf.conv_epilogue_backward([g], None, fmt, True)
    with pytest.raises(ValueError, match="float32 or float16"):
        sf.conv_epilogue_backward([g.double()], None, fmt, False)
