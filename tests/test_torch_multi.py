"""Golden tests: the rest of the port's serving path against JAX — the
top-4 direct path in float32 and bf16, the mixed-family and wide-yaw
assets, the corner decode, the corner head end to end, predict_images,
the tracker and the multi-vehicle generators.

The JAX answers are computed once per module on the same numpy inputs
(`make_torch_port_golden.golden_multi_arrays`), which also checks that
tests/data/torch_port_golden_multi.npz is current.

Tolerances (tests/torch_golden.py): `found`, `vote_overflow` and top-k
order exactly; float32 poses within POSE_ATOL (1e-4); poses from a bf16
FCN within BF16_POSE_ATOL (1e-3); yaw compared as an angle (the fit's
pi tie, ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import make_torch_port_golden as maker
from tests.torch_golden import (
    ASSET,
    BF16_POSE_ATOL,
    BF16_PROB_ATOL,
    BF16_REG_ATOL,
    GOLDEN_MULTI,
    MIXED_ASSET,
    POSE_ATOL,
    YAW_ASSET,
    asset_configs,
    jax_model_from_arrays,
    load_npz,
    port_asset_model,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.decode import decode as jd
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion.predict import predict_images as jax_predict_images
from tpufusion_torch._golden import BF16_REG_DIFFER_SHARE, bf16_fcn_readings
from tpufusion_torch.config import DEFAULT, DecodeConfig, ModelConfig, RangeViewSpec
from tpufusion_torch.data.synthetic import (
    synthesize_beam_multi_vehicle_batch,
    synthesize_beam_scan_batch,
    synthesize_beam_tracking_sequence,
)
from tpufusion_torch.decode import decode as td
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models import fcn
from tpufusion_torch.models.io import fcn_from_arrays
from tpufusion_torch.predict import make_e2e_step, predict_images
from tpufusion_torch.serve.tracker import PoseTracker, track_quality_metrics

SPEC = RangeViewSpec()
JSPEC = to_jax_config(SPEC)  # the JAX side gets its own config classes


@pytest.fixture(scope="module")
def jax_golden():
    """JAX's answers on the golden inputs, computed in this process."""
    return maker.golden_multi_arrays()


@pytest.fixture(scope="module")
def committed():
    return load_npz(GOLDEN_MULTI)


def _asset_fcn(asset, dtype="float32"):
    return port_asset_model(asset, dtype), asset_configs(asset)[1]


def _assert_poses(got_poses, got_found, want_poses, want_found, atol):
    np.testing.assert_array_equal(np.asarray(got_found), want_found)
    diff = wrapped_pose_diff(np.asarray(got_poses), want_poses)
    assert diff.max() <= atol, diff.max()


def test_golden_multi_file_is_current(jax_golden, committed):
    """tests/data/torch_port_golden_multi.npz equals what the JAX package
    computes now (rerun tests/make_torch_port_golden.py if not)."""
    assert sorted(committed) == sorted(jax_golden)
    for k, v in jax_golden.items():
        if k.endswith("_poses"):
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=1e-6, err_msg=k)
        elif k.startswith("bf16_fcn_"):  # XLA's bf16 rounding may vary by CPU
            atol = BF16_PROB_ATOL if k.endswith("prob") else BF16_REG_ATOL
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(committed[k], v, err_msg=k)
    # every path the card checks detects something, both vehicles included
    for k in ("direct_f32", "direct_bf16", "mixed", "yaw", "hybrid_k4"):
        assert jax_golden[f"{k}_found"][:3, :2].all(), k
    assert jax_golden["corner_found"].all() and jax_golden["corner_k64_overflow"].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e2e_direct_top4_matches_jax(jax_golden, dtype):
    """Config 5's path: the shipped asset, top-4, in both dtypes; k=1 is
    lane 0 of the top-4 (the clusters are ranked the same way)."""
    model, dcfg = _asset_fcn(ASSET, dtype)
    tag = "f32" if dtype == "float32" else "bf16"
    atol = POSE_ATOL if dtype == "float32" else BF16_POSE_ATOL
    pts, valid = jax_golden["multi_points"], jax_golden["multi_valid"]
    want_p, want_f = jax_golden[f"direct_{tag}_poses"], jax_golden[f"direct_{tag}_found"]
    poses, found = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head="direct",
                                 device="cpu")(pts, valid)
    assert poses.shape == (3, 4, 7) and found.shape == (3, 4)
    _assert_poses(poses, found, want_p, want_f, atol)
    poses1, found1 = make_e2e_step(model, SPEC, dcfg, head="direct", device="cpu")(pts, valid)
    assert poses1.shape == (3, 7)
    _assert_poses(poses1, found1, want_p[:, 0], want_f[:, 0], atol)


def _one_rounding_forward(conv, x, transpose):
    """Conv / ConvTranspose.forward rounded once: the convolution and the
    bias summed in float32, then rounded to bf16, where flax rounds the
    convolution and then the sum (a fused bias epilogue does this)."""
    k = conv.kernel.to(x.dtype).permute(3, 2, 0, 1).float()
    (sh, sw), (b, c, h, w) = conv.strides, x.shape
    if transpose:
        z = x.new_zeros(b, c, (h - 1) * sh + 1, (w - 1) * sw + 1)
        z[:, :, ::sh, ::sw] = x
        ph, pw, stride = fcn._transpose_pad(sh), fcn._transpose_pad(sw), 1
    else:
        z, ph, pw, stride = x, fcn._same_pad(h, sh), fcn._same_pad(w, sw), conv.strides
    z = torch.nn.functional.pad(z.float(), (pw[0], pw[1], ph[0], ph[1]))
    y = torch.nn.functional.conv2d(z, k, stride=stride)
    return (y + conv.bias.to(x.dtype).float().view(-1, 1, 1)).to(x.dtype)


@pytest.mark.parametrize("rounding", ["flax", "once"])
def test_bf16_fcn_against_the_golden_sample(committed, monkeypatch, rounding):
    """The check the card makes of its bf16 FCN (chip_smoke phase 6): the
    golden's sample of JAX's bf16 output, probabilities within 2**-8,
    regression within 2**-4 and at most BF16_REG_DIFFER_SHARE of its
    outputs off at all. The port passes it; rounding each convolution
    once instead of twice, a fault a fused bias epilogue would bring,
    fails it."""
    if rounding == "once":
        monkeypatch.setattr(fcn.Conv, "forward", lambda m, x: _one_rounding_forward(m, x, False))
        monkeypatch.setattr(
            fcn.ConvTranspose, "forward", lambda m, x: _one_rounding_forward(m, x, True)
        )
    images = range_view_project_batch(
        torch.from_numpy(committed["multi_points"]), SPEC,
        torch.from_numpy(committed["multi_valid"]),
    )
    with torch.inference_mode():
        out = port_asset_model(ASSET, "bfloat16")(images).numpy()
    dp, dr, n_diff, n = bf16_fcn_readings(
        out, committed["bf16_fcn_prob"], committed["bf16_fcn_reg"]
    )
    passes = dp <= BF16_PROB_ATOL and dr <= BF16_REG_ATOL and n_diff <= BF16_REG_DIFFER_SHARE * n
    assert passes == (rounding == "flax"), (dp, dr, n_diff, n)


@pytest.mark.parametrize("asset", ["mixed", "yaw"])
def test_e2e_assets_top4_match_jax(jax_golden, asset):
    """The mixed-family asset decodes with the dual-codec auto gates, the
    wide-yaw asset with local yaw and the ellipse fit, on two-vehicle
    circle frames and oriented ellipse frames."""
    model, dcfg = _asset_fcn({"mixed": MIXED_ASSET, "yaw": YAW_ASSET}[asset])
    if asset == "mixed":
        assert (dcfg.direct_yaw_frame, dcfg.fit_boundary) == ("auto", "auto")
    # one frame of each family (the card checks all five)
    pts = np.stack([jax_golden["multi_points"][0], jax_golden["ell_points"][0]])
    valid = np.stack([jax_golden["multi_valid"][0], jax_golden["ell_valid"][0]])
    frames = [0, 3]
    poses, found = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head="direct",
                                 device="cpu")(pts, valid)
    _assert_poses(
        poses, found, jax_golden[f"{asset}_poses"][frames],
        jax_golden[f"{asset}_found"][frames], POSE_ATOL,
    )


def _corner_inputs(jax_golden):
    images = range_view_project_batch(
        torch.from_numpy(jax_golden["multi_points"][:2]), SPEC,
        torch.from_numpy(jax_golden["multi_valid"][:2]),
    )
    return torch.from_numpy(jax_golden["corner_ypred"]), images


@pytest.mark.parametrize("case", ["corner", "corner_multi", "corner_k64"])
def test_corner_decode_matches_jax(jax_golden, case):
    """decode_batch, decode_batch_multi(k=4) and decode_batch with a
    64-candidate budget (every frame overflows) on label-encoded corner
    outputs of two-vehicle frames."""
    y, images = _corner_inputs(jax_golden)
    if case == "corner_multi":
        out = td.decode_batch_multi(y, images, SPEC, DecodeConfig(), 4)
        poses = out["poses"]
    else:
        cfg = DecodeConfig(
            max_candidates=maker.CORNER_MAX_CANDIDATES_SMALL if case == "corner_k64" else 2048
        )
        out = td.decode_batch(y, images, SPEC, cfg)
        poses = out["pose"]
    _assert_poses(
        poses, out["found"], jax_golden[f"{case}_poses"], jax_golden[f"{case}_found"], POSE_ATOL
    )
    np.testing.assert_array_equal(
        out["vote_overflow"].numpy(), jax_golden[f"{case}_overflow"]
    )


def test_corner_decode_intermediates_match_jax(jax_golden):
    """Every product of decode_batch: the 2D cluster, its 3D centroid,
    the voted corners and the area."""
    y, images = _corner_inputs(jax_golden)
    got = td.decode_batch(y, images, SPEC, DecodeConfig())
    want = jax.jit(jd.decode_batch, static_argnums=(2, 3))(
        jnp.asarray(y.numpy()), jnp.asarray(images.numpy()), JSPEC,
        to_jax_config(DecodeConfig()),
    )
    assert sorted(got) == sorted(want)
    for k in ("found", "centroid_2d", "bbox_2d", "area", "vote_overflow"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("pose", "centroid_3d", "corners_3d"):
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]), rtol=0, atol=POSE_ATOL, err_msg=k
        )


def test_corner_vote_overflow_keeps_the_scan_order(jax_golden):
    """With a small budget the vote keeps the first K candidates in
    column-major order: the same slots as JAX's rank inversion, hence the
    same winners and box, and overflow where more were there."""
    y, images = _corner_inputs(jax_golden)
    centroid, bbox, _, found = td._find_obstacle_batch(y[..., 1], DecodeConfig())
    xyz, _, _ = td.back_project_2d_to_3d(
        centroid, bbox, images[..., 0], images[..., 1], SPEC, DecodeConfig()
    )
    jax_vote = jax.jit(
        jax.vmap(jd.corner_vote, in_axes=(0, 0, 0, 0, None, None)), static_argnums=(4, 5)
    )
    for budget in (16, 300, 2048):
        cfg = DecodeConfig(max_candidates=budget)
        pose, box, ok, overflow = td.corner_vote(
            y, images, bbox[:, None], xyz[:, None], SPEC, cfg
        )
        w_pose, w_box, w_ok, w_over = jax_vote(
            jnp.asarray(y.numpy()), jnp.asarray(images.numpy()),
            jnp.asarray(bbox.numpy()), jnp.asarray(xyz.numpy()), JSPEC, to_jax_config(cfg),
        )
        np.testing.assert_array_equal(ok[:, 0].numpy(), np.asarray(w_ok))
        np.testing.assert_array_equal(overflow[:, 0].numpy(), np.asarray(w_over))
        np.testing.assert_allclose(box[:, 0].numpy(), np.asarray(w_box), rtol=0, atol=POSE_ATOL)
        assert wrapped_pose_diff(pose[:, 0].numpy(), np.asarray(w_pose)).max() <= POSE_ATOL
        assert bool(overflow.all()) == (budget == 16)
    assert found.all() and ok.all()


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_corner_vote_ignores_the_matmul_precision(jax_golden, precision):
    """The vote's Gram product runs in full float32 whatever the
    process's float32 matmul precision (TF32 on the card, bf16 passes in
    oneDNN on some CPUs), and leaves the setting as it found it."""
    y, images = _corner_inputs(jax_golden)
    torch.set_float32_matmul_precision(precision)
    try:
        out = td.decode_batch_multi(y, images, SPEC, DecodeConfig(), 4)
        assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision("highest")
    _assert_poses(
        out["poses"], out["found"], jax_golden["corner_multi_poses"],
        jax_golden["corner_multi_found"], POSE_ATOL,
    )


@pytest.mark.parametrize("tag", ["k1", "k4", "bf16_k4"])
def test_e2e_corner_head_matches_jax(jax_golden, tag):
    """make_e2e_step(head="corner") with a corner head on the asset's
    trunk: the corner path end to end with real detections."""
    mcfg, arrays = maker.hybrid_corner_arrays()
    bf16 = tag.startswith("bf16")
    k = int(tag[-1])
    if bf16:
        mcfg = dataclasses.replace(mcfg, dtype="bfloat16")
    model = fcn_from_arrays(arrays, mcfg, device="cpu")
    _, dcfg = asset_configs()
    poses, found = make_e2e_step(
        model, SPEC, dcfg, max_obstacles=k, head="corner", device="cpu"
    )(jax_golden["multi_points"], jax_golden["multi_valid"])
    assert poses.shape == ((3, 7) if k == 1 else (3, k, 7))
    _assert_poses(
        poses, found, jax_golden[f"hybrid_{tag}_poses"], jax_golden[f"hybrid_{tag}_found"],
        BF16_POSE_ATOL if bf16 else POSE_ATOL,
    )


def test_e2e_bench_corner_row_matches_jax(jax_golden):
    """bench.py's corner row: default ModelConfig in bf16, seeded weights,
    a background-leaning softmax (nothing crosses min_prob)."""
    arrays = {
        k.split("/", 1)[1]: v for k, v in jax_golden.items() if k.startswith("bench_corner/")
    }
    model = fcn_from_arrays(
        arrays, dataclasses.replace(ModelConfig(), dtype="bfloat16"), device="cpu")
    poses, found = make_e2e_step(model, SPEC, DecodeConfig(), head="corner", device="cpu")(
        jax_golden["multi_points"], jax_golden["multi_valid"]
    )
    _assert_poses(
        poses, found, jax_golden["bench_corner_poses"], jax_golden["bench_corner_found"],
        BF16_POSE_ATOL,
    )


@pytest.mark.parametrize("head", ["direct", "corner"])
def test_predict_images_matches_jax(jax_golden, head):
    """The offline batch entry point, 5 frames in batches of 2 (the last
    one padded)."""
    pts = np.concatenate([jax_golden["multi_points"], jax_golden["ell_points"]])
    valid = np.concatenate([jax_golden["multi_valid"], jax_golden["ell_valid"]])
    images = np.asarray(jax_project(jnp.asarray(pts), JSPEC, jnp.asarray(valid)))
    mcfg, dcfg = asset_configs()
    if head == "corner":
        mcfg, arrays = maker.hybrid_corner_arrays()
    else:
        arrays = load_npz(ASSET)
    cfg = DEFAULT.replace(model=mcfg, decode=dcfg)
    want_p, want_f = jax_predict_images(
        jax_model_from_arrays(mcfg, arrays), images, to_jax_config(cfg), 2
    )
    got_p, got_f = predict_images(
        fcn_from_arrays(arrays, mcfg, device="cpu"), images, cfg, 2, device="cpu")
    assert got_p.shape == (5, 7) and got_p.dtype == np.float32 and got_f.shape == (5,)
    _assert_poses(got_p, got_f, want_p, want_f, POSE_ATOL)
    assert got_f.sum() >= 3


def _jax_topk(prob, cfg, k):
    cfg = to_jax_config(cfg)
    fn = jax.vmap(lambda p: jd.find_obstacles_topk(p, cfg, k))
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(prob))]


def _blob_frames():
    """Heat inputs with equal-area clusters in every order, and fewer
    clusters than k."""
    prob = np.zeros((3, 32, 181), np.float32)
    for r0, c0 in ((4, 150), (4, 40), (18, 90), (18, 10)):  # four equal blobs
        prob[0, r0 : r0 + 8, c0 : c0 + 12] = 1.0
    prob[1, 10:20, 60:80] = 1.0  # one large blob, then two equal ones
    prob[1, 2:8, 120:130] = 1.0
    prob[1, 24:30, 5:15] = 1.0
    prob[2, 12:18, 100:110] = 1.0  # one cluster, k = 6
    return prob


@pytest.mark.parametrize("k", [1, 3, 6])
def test_topk_order_with_ties_matches_lax_top_k(k):
    """lax.top_k's stable order: equal areas to the smaller root index,
    and the padding entries (score -1) when k exceeds the clusters too."""
    prob = _blob_frames()
    cfg = DecodeConfig(min_bbox_area=8.0)
    got = td._find_obstacles_topk_batch(torch.from_numpy(prob), cfg, k)
    want = _jax_topk(prob, cfg, k)
    for g, w, name in zip(got, want, ("centroids", "bboxes", "areas", "found")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    for f in range(len(prob)):  # the public form takes one frame, as the reference's
        for g, w in zip(td.find_obstacles_topk(torch.from_numpy(prob[f]), cfg, k), want):
            np.testing.assert_array_equal(g.numpy(), w[f])
    comps = td._heat_components(torch.from_numpy(prob), cfg)
    idx = td._topk_roots(*comps, cfg, k)[0].numpy()
    jcfg = to_jax_config(cfg)
    jidx = jax.jit(
        jax.vmap(lambda p: jd._topk_roots(*jd._heat_components(p, jcfg), jcfg, k)[0])
    )(jnp.asarray(prob))
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    if k == 6:
        assert got[3].numpy().sum(axis=1).tolist() == [4, 3, 1]


def test_find_obstacle_ties_match_jax():
    """The corner path's largest cluster: among equal areas the smallest
    root label."""
    prob = _blob_frames()
    cfg = DecodeConfig(min_bbox_area=8.0)
    got = td._find_obstacle_batch(torch.from_numpy(prob), cfg)
    jcfg = to_jax_config(cfg)
    want = jax.jit(jax.vmap(lambda p: jd.find_obstacle(p, jcfg)))(jnp.asarray(prob))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for f in range(len(prob)):  # the public form takes one frame, as the reference's
        for g, w in zip(td.find_obstacle(torch.from_numpy(prob[f]), cfg), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w)[f])


def _one_frame_map(seed: int, h: int, w: int) -> np.ndarray:
    """One seeded (H, W) probability map: sub-threshold noise, a few
    blobs at random places and sizes, and the two of the reference's
    example (rows 10-17 x columns 100-127, rows 20-23 x columns 20-27)."""
    rng = np.random.default_rng(seed)
    prob = rng.uniform(0.0, 0.45, (h, w)).astype(np.float32)
    prob[10:18, 100:128] = 0.9
    prob[20:24, 20:28] = 0.8
    for _ in range(rng.integers(1, 5)):
        r0, c0 = rng.integers(0, h - 6), rng.integers(0, w - 40)
        prob[r0 : r0 + rng.integers(3, 7), c0 : c0 + rng.integers(4, 40)] = rng.uniform(0.5, 1.0)
    return prob


@pytest.mark.parametrize("seed,h,w", [(0, 32, 1801), (1, 32, 1801), (2, 63, 1801), (3, 32, 181)])
def test_find_obstacle_takes_one_frame_as_jax(seed, h, w):
    """The reference's per-frame call: an (H, W) map in, (centroid (2,),
    bbox (4,), area, found) out; integers exact, the area exact in
    float32."""
    prob = _one_frame_map(seed, h, w)
    cfg = DecodeConfig()
    got = td.find_obstacle(torch.from_numpy(prob), cfg)
    want = jax.jit(lambda p: jd.find_obstacle(p, to_jax_config(cfg)))(jnp.asarray(prob))
    for g, wnt, shape, dtype in zip(got, want, ((2,), (4,), (), ()),
                                    (torch.int32, torch.int32, torch.float32, torch.bool)):
        assert tuple(g.shape) == shape and g.dtype == dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert bool(got[3])


@pytest.mark.parametrize("seed,h,w", [(0, 32, 1801), (2, 63, 1801), (3, 32, 181)])
@pytest.mark.parametrize("k", [1, 4])
def test_find_obstacles_topk_takes_one_frame_as_jax(seed, h, w, k):
    prob = _one_frame_map(seed, h, w)
    cfg = DecodeConfig()
    got = td.find_obstacles_topk(torch.from_numpy(prob), cfg, k)
    want = jax.jit(lambda p: jd.find_obstacles_topk(p, to_jax_config(cfg), k))(jnp.asarray(prob))
    for g, wnt, shape in zip(got, want, ((k, 2), (k, 4), (k,), (k,))):
        assert tuple(g.shape) == shape and g.numpy().dtype == np.asarray(wnt).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert bool(got[3][0])


def _detections(seed=0, frames=20):
    """Two vehicles on straight paths, misses, jitter and clutter."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((frames, 4, 7), np.float32)
    found = np.zeros((frames, 4), bool)
    for f in range(frames):
        for v, (x0, y0, vx) in enumerate(((10.0, 3.0, 1.0), (-8.0, -6.0, -0.5))):
            if rng.random() < 0.85:
                poses[f, v, :3] = (x0 + vx * 0.1 * f, y0, -0.7) + rng.normal(0, 0.1, 3)
                poses[f, v, 4:] = (4.2, 1.6, 1.5)
                found[f, v] = True
        if rng.random() < 0.3:
            poses[f, 2, :3] = rng.uniform(-30, 30, 3)
            found[f, 2] = True
    gt = np.stack(
        [[(10.0 + 0.1 * f, 3.0, -0.7), (-8.0 - 0.05 * f, -6.0, -0.7)] for f in range(frames)]
    )
    return poses, found, gt


def test_tracker_matches_jax_module():
    """The port's copy of the reference's tracker: the same detections
    give identical trails and metrics."""
    from tpufusion.serve import tracker as jt

    poses, found, gt = _detections()
    got = PoseTracker(dt=0.1).run_multi(poses, found)
    want = jt.PoseTracker(dt=0.1).run_multi(poses, found)
    assert sorted(got) == sorted(want)
    for tid in want:
        assert [f for f, _ in got[tid]] == [f for f, _ in want[tid]]
        np.testing.assert_array_equal(
            np.stack([p for _, p in got[tid]]), np.stack([p for _, p in want[tid]])
        )
    assert track_quality_metrics(got, gt) == jt.track_quality_metrics(want, gt)
    assert track_quality_metrics(got, gt)["vehicles_tracked"] == 2


def test_numpy_multi_vehicle_scans_feed_the_top4_path():
    """The numpy generators (the card's inputs): two vehicles per frame,
    a 16-frame tracking sequence, and 64 beams at 131,072 points; the
    asset finds both vehicles and the tracker confirms both."""
    model, dcfg = _asset_fcn(ASSET)
    step = make_e2e_step(model, SPEC, dcfg, max_obstacles=4, head="direct", device="cpu")
    pts, gt, valid = synthesize_beam_multi_vehicle_batch(np.random.default_rng(3), 2)
    assert pts.shape == (2, 32768, 4) and gt["center"].shape == (2, 2, 3)
    poses, found = step(pts, valid)
    assert found[:, :2].all()
    seq, sgt, svalid = synthesize_beam_tracking_sequence(np.random.default_rng(77), 6)
    assert seq.shape == (6, 32768, 4) and sgt["center"].shape == (6, 2, 3)
    np.testing.assert_allclose(
        np.diff(sgt["center"], axis=0), np.diff(sgt["center"], axis=0)[:1].repeat(5, 0),
        atol=1e-5,
    )  # constant velocity
    poses, found = step(seq, svalid)
    trails = PoseTracker(dt=0.1).run_multi(poses.numpy(), found.numpy())
    assert track_quality_metrics(trails, sgt["center"])["vehicles_tracked"] == 2
    big, _, bvalid = synthesize_beam_scan_batch(np.random.default_rng(1), 1, 131072, n_beams=64)
    assert big.shape == (1, 131072, 4) and 0.4 < bvalid.mean() < 0.9
    oseq, ogt, _ = synthesize_beam_tracking_sequence(np.random.default_rng(0), 2, oriented=True)
    assert oseq.shape == (2, 32768, 4) and (ogt["yaw"] == ogt["yaw"][:1]).all()
    with pytest.raises(ValueError):
        synthesize_beam_multi_vehicle_batch(np.random.default_rng(0), 1, n_vehicles=6)
