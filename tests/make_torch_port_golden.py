"""Writes the JAX goldens that check the PyTorch port where JAX is not
installed (chip_smoke.py holds the port on the GPU against them):

tests/data/torch_port_golden.npz: the JAX main path's answer on two
beam-scan frames. It holds the points themselves (numpy's vectorised
trigonometry may differ by ulps between CPUs, so they are stored, not
regenerated), their validity mask, the JAX e2e `found` and poses with the
shipped detector asset, and each frame's JAX range-view image as a
sha256 and an occupied-pixel count.

tests/data/torch_port_golden_multi.npz: the rest of the serving path.
  multi_*       3 two-vehicle beam frames (32,768 points) and
  ell_*         2 single-vehicle frames with the oriented ellipse surface
  direct_{f32,bf16}_*  JAX make_e2e_step(head="direct", max_obstacles=4)
                with the shipped asset in float32 and bfloat16 on multi
  bf16_fcn_*    the asset's JAX bf16 FCN on multi: the foreground
                probability at every pixel, the regression outputs at
                every 17th pixel (tpufusion_torch/_golden.py)
  {mixed,yaw}_* the mixed-family and wide-yaw assets, top-4, float32, on
                multi + ell (the mixed asset's auto yaw and fit gates)
  corner_ypred  label-encoded corner outputs (encode_label_batch of both
                vehicles of multi frames 0-1, footprint offsets perturbed
                by N(0, 0.3) m) with JAX decode_batch (corner_*),
                decode_batch_multi(k=4) (corner_multi_*) and decode_batch
                at max_candidates 64 (corner_k64_*, the overflow case)
  hybrid/*      a corner head on the shipped asset's classification trunk
                (deconv5b/6b drawn U(-0.05, 0.05) from a seed), with JAX
                make_e2e_step(head="corner") at k=1 and k=4 in float32
                and k=4 in bf16 on multi (hybrid_{k1,k4,bf16_k4}_*): a
                corner path that detects
  bench_corner/* bench.py's corner-row FCN (default ModelConfig, seeded
                JAX init, deconv6a bias [2, -2]) and its bf16 corner e2e
                answer on multi (bench_corner_*)

tests/data/torch_port_golden_fusion.npz: the BEV, the fusion net and
config 3 (tpufusion_torch/_golden.py names the seeds and sizes).
  bev_*         3 frames x 4,096 points (two stretched beam scans and the
                edge-case cloud) and JAX's bev_rasterize_batch on them
                (default BevSpec) as the non-zero cells' flat indices and
                values
  fusion_*      8 fusion frames from the port's numpy generator: the lidar
                points, masks and radar rows are stored, the camera frames
                are made again from the seed and held to fusion_cam_sha256;
                JAX's FusionNet with the shipped fusion_net.npz on them in
                float32 and bfloat16 (fusion_{f32,bf16}_{centroid,rz})
  bev_fcn/*     config 3's BEV FCN (default ModelConfig in bf16, seeded
                JAX init nnx.Rngs(1))
  seg_prob      config 3's seg on the first 2 fusion frames (BEV with the
                height channel + the painted camera through the BEV FCN):
                the foreground probability at every 17th pixel

tests/data/torch_port_golden_train.npz: one train step of the reference
(tpufusion_torch/_golden.py names the seeds, sizes and cases).
  inputs_sha256 the digest of the 4 frames x 32,768 points (and their
                ground truth) the port's numpy generator makes from
                TRAIN_SEED; they are made again where the golden is used
  <case>/*      for direct_f32 (the shipped asset's model and yaw frame,
                no augmentation), corner_f32 (a corner head on the asset's
                trunk, rolled by corner_f32/shifts, JAX's own draws) and
                direct_bf16: the labels' foreground pixels and every 5th
                one's values, make_train_step's loss and metrics and the
                BatchNorm statistics after it, and every gradient tensor
                (bf16: the upper 16 bits, which hold them exactly)
  fusion_{f32,bf16}/*  one fusion step (train=True, dropout rates 0) of
                the shipped fusion_net.npz on the fusion golden's 8
                frames: the loss, each gradient tensor's largest entry and
                a sample of its entries, the BatchNorm statistics after

tests/data/torch_port_golden_viewer.npz: the JPEG bytes the live viewer's
encoder must write (tpufusion_torch/_golden.py names the seed and sizes).
  jpeg_<i>      cv2.imencode(".jpg", frame_i, [IMWRITE_JPEG_QUALITY, 88])
                of the i-th frame of `viewer_golden_frames` (32 x 1801 x 3
                and 1199 x 180 x 3 BGR), as uint8
  frame_sha256  the frames' digests; the frames are made again from the seed

tests/data/torch_port_golden_tall.npz: a 64-beam sensor's 63 x 1801 range
view (tpufusion_torch/_golden.py names the spec, seed and sizes).
  points, valid 4 frames of the port's numpy beam scans at 64 beams
  found, poses  JAX make_e2e_step(head="direct") with the shipped asset in
                float32 at RangeViewSpec(res_v_deg=0.665)

tests/data/torch_port_golden_bench.npz: the repo's headline, bench.py and
__graft_entry__.entry() (tpufusion_torch/_golden.py names the seed and
sizes).
  points, valid 4 frames of JAX's beam scans (32,768 points, PRNGKey 0)
  flagship/*    bench.py's headline net: the flagship geometry in bf16,
                seeded JAX init nnx.Rngs(0), deconv6a bias [2, -2]
  flagship_{bf16,f32}_*  JAX make_e2e_step(head="direct") with those
                weights at DEFAULT.decode in bf16 and float32 (poses,
                found), and the FCN's foreground probability at every
                FCN_REG_STRIDE-th pixel (prob) and its largest value a
                frame (prob_max)
  entry/*       the state of JAX's entry() (the float32 flagship, nnx.Rngs(0))
  entry_*       its example points (4 x 8,192, PRNGKey 0) and its fn's
                poses and found on them, run eagerly

tests/data/torch_port_golden_packed.npz: the reference's projection
methods on near-tie frames (tpufusion_torch/_golden.py names the recipe):
the bench golden's 4 frames, each with its first 1,024 points repeated
and jittered (`near_tie_sets`: "" 33,792 points a frame, "short_" the
recipe on the first 31,744, 32,768 a frame; not stored, made again on the
card and held to {,short_}frames_sha256).
  {,short_}<method>_sha256  JAX range_view_project_batch (eager) under
                each of "exact", "pallas", "scatter", "sort16" and
                "packed", the sha256 of each frame's image; "sort16"
                only on the short set (the reference asserts N <= 2**15:
                sort16_refused)
  {,short_}packed_exact_pixels  the pixels a frame where "packed"
                differs from "exact" (the generator refuses a golden where
                none does)
  packed_step_{found,poses}  JAX make_e2e_step(method="packed",
                head="direct") with the shipped asset in float32 on the
                33,792-point frames

tests/data/torch_port_golden_bf16.npz: the direct decode of a bf16 head
output (tpufusion_torch/_golden.py names the frames and the cases).
  images        the multi golden's first two-vehicle and first ellipse
                frame, JAX's range views (2 x 32 x 1801 x 3)
  {asset,mixed}_bits  the shipped and the mixed assets' JAX FCN outputs on
                them rounded to bf16, as their upper 16 bits
  <case>_{poses,found}  JAX decode_batch_direct on the bf16 output at
                k = BF16_DECODE_K, for each of BF16_DECODE_CASES

tests/data/torch_port_golden_f16.npz: the float16 configuration
(tpufusion_torch/_golden.py names the frames and the cases).
  {asset,mixed}_bits  the shipped and the mixed assets' JAX FCN outputs on
                the bf16 golden's images rounded to float16, as float16 bits
  <case>_{poses,found}  JAX decode_batch_direct on the float16 output at
                k = F16_DECODE_K, <case>_k1_{poses,found} at k = 1, for
                each of F16_DECODE_CASES
  fcn_prob, fcn_reg_bits  the asset's JAX float16 FCN on the multi
                golden's three two-vehicle frames: the foreground
                probability at every pixel, the regression outputs (float16
                values) at every 17th pixel as float16 bits
  e2e_{poses,found}  JAX make_e2e_step(head="direct", max_obstacles=
                F16_E2E_K) with the shipped asset in float16 on those frames

tests/data/torch_port_golden_f8.npz: the small-float configurations
(tpufusion_torch/_golden.py names the frames and the formats).
  <format>_features  the asset's JAX FCN features in each of the nine
                formats of ops/small_float.py on the multi golden's first
                two two-vehicle frames, as the format's codes (uint8),
                at every 17th pixel
  <format>_prob the foreground probability at the same pixels
  e2e_<format>_{poses,found}  JAX make_e2e_step(head="direct",
                max_obstacles=F8_E2E_K) with the shipped asset in
                float8_e4m3fn and in float8_e5m2 on the three frames

tests/data/torch_port_golden_f8_grad.npz: training in the small floats
(tpufusion_torch/_golden.py, F8_GRAD_*).
  points, valid, center, size, yaw  two beam scans of the port's numpy
                generator (seed F8_GRAD_SEED): the inputs
  <format>/loss, <format>/<layer>/<param>  JAX's loss and gradients of
                the shipped asset's FCN in each of the nine formats on
                their full-width range views (train=True, the direct
                head's labels, LossConfig(**F8_GRAD_LOSS))

tests/test_torch_e2e.py, tests/test_torch_multi.py,
tests/test_torch_fusion.py, tests/test_torch_train.py,
tests/test_torch_viewer.py, tests/test_torch_tall_views.py,
tests/test_torch_bench.py, tests/test_torch_projection_methods.py and
tests/test_torch_small_float_train.py recompute them (the train golden's fusion steps excepted: 8 full-size
camera frames backward) and fail when a file is stale.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py [train | viewer | tall | bench | packed | bf16 | f16 | f8 | f8_grad]

With `train` (`viewer`, `tall`, `bench`, `packed`, `bf16`, `f16`, `f8`,
`f8_grad`) only the train (viewer, tall, bench, packed, bf16, f16, f8,
f8 gradient) golden is rewritten.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

MULTI_SEED = 21  # JAX PRNGKey of the two-vehicle frames
ELL_SEED = 22  # JAX PRNGKey of the ellipse frames
CORNER_NOISE_SEED = 0  # numpy seed of the corner offsets' perturbation
HYBRID_SEED = 5  # numpy seed of the hybrid corner head's regression branch
CORNER_MAX_CANDIDATES_SMALL = 64


def golden_arrays() -> dict[str, np.ndarray]:
    from tests.torch_golden import (
        GOLDEN_SEED,
        image_digest,
        jax_beam_scans,
        jax_e2e,
        occupied_pixels,
    )

    points, valid = jax_beam_scans(GOLDEN_SEED, 2)
    poses, found, images = jax_e2e(points, valid)
    return {
        "points": points,
        "valid": valid,
        "found": found.astype(bool),
        "poses": poses.astype(np.float32),
        "image_sha256": np.array([image_digest(im) for im in images]),
        "occupied": np.array([occupied_pixels(im) for im in images], np.int64),
    }


def corner_label_ypred(images: np.ndarray, gt: dict) -> np.ndarray:
    """(B, H, W, 26) corner-head outputs from the label encoder: both
    vehicles' footprints merged, their corner offsets perturbed."""
    import jax
    import jax.numpy as jnp

    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.encoding import encode_label_batch

    encode = jax.jit(encode_label_batch, static_argnums=4)
    labs = [
        np.asarray(
            encode(
                jnp.asarray(gt["center"][:, v]), jnp.asarray(gt["size"][:, v]),
                jnp.asarray(gt["yaw"][:, v]), jnp.asarray(images), RangeViewSpec(),
            )
        )
        for v in range(gt["center"].shape[1])
    ]
    fg = np.maximum(labs[0][..., 1], labs[1][..., 1])
    reg = np.where(labs[1][..., 1:2] > 0.5, labs[1][..., 2:], labs[0][..., 2:])
    noise = np.random.default_rng(CORNER_NOISE_SEED).normal(0.0, 0.3, reg.shape)
    reg = reg + (fg[..., None] > 0.5) * noise
    return np.concatenate([(1.0 - fg)[..., None], fg[..., None], reg], -1).astype(
        np.float32
    )


def hybrid_corner_arrays() -> tuple:
    """(ModelConfig, arrays): a corner head (width 2, linear) whose shared
    layers are the shipped asset's and whose regression branch is drawn
    from HYBRID_SEED like the reference's keras init."""
    from tests.torch_golden import ASSET, asset_configs, load_npz

    mcfg = dataclasses.replace(asset_configs()[0], head="corner")
    arrays = {
        k: v for k, v in load_npz(ASSET).items()
        if not k.startswith(("deconv5b/", "deconv6b/"))
    }
    rng = np.random.default_rng(HYBRID_SEED)
    wm, nreg = mcfg.width_multiplier, mcfg.num_corner_outputs
    for name, cin in (("deconv5b", 22 * wm), ("deconv6b", 4 * wm + nreg)):
        arrays[f"{name}/kernel"] = rng.uniform(-0.05, 0.05, (5, 5, cin, nreg)).astype(
            np.float32
        )
        arrays[f"{name}/bias"] = np.zeros(nreg, np.float32)
    return mcfg, arrays


def bench_net_arrays(**model_kw) -> tuple:
    """(ModelConfig, arrays) of a bench.py net: ModelConfig(**model_kw)
    in bf16, seeded init (nnx.Rngs(0)), deconv6a bias [2, -2] (a
    background-leaning softmax, as a trained detector's)."""
    from tpufusion.config import ModelConfig

    mcfg = dataclasses.replace(ModelConfig(), dtype="bfloat16", **model_kw)
    arrays = seeded_fcn_arrays(mcfg, 0)
    arrays["deconv6a/bias"] = np.array([2.0, -2.0], np.float32)
    return mcfg, arrays


def golden_multi_arrays() -> dict[str, np.ndarray]:
    import jax
    import jax.numpy as jnp

    from tests.torch_golden import (
        MIXED_ASSET,
        YAW_ASSET,
        asset_configs,
        jax_asset_model,
        jax_forward,
        jax_model_from_arrays,
        jax_step,
    )
    from tpufusion_torch._golden import fcn_golden_sample
    from tpufusion.config import DecodeConfig, RangeViewSpec
    from tpufusion.data.synthetic import (
        synthesize_beam_multi_vehicle_batch,
        synthesize_beam_scan_batch,
    )
    from tpufusion.decode.decode import decode_batch, decode_batch_multi
    from tpufusion.geometry.range_view import range_view_project_batch

    spec = RangeViewSpec()
    out: dict[str, np.ndarray] = {}
    pts, gt, valid = jax.jit(synthesize_beam_multi_vehicle_batch, static_argnums=(1, 2))(
        jax.random.PRNGKey(MULTI_SEED), 3, 32768
    )
    out["multi_points"] = np.array(pts, np.float32)
    out["multi_valid"] = np.array(valid, bool)
    out["multi_center"] = np.array(gt["center"], np.float32)
    ell_pts, _, ell_valid = jax.jit(
        lambda key: synthesize_beam_scan_batch(
            key, 2, 32768, max_yaw=0.45, vehicle_surface="ellipse"
        )
    )(jax.random.PRNGKey(ELL_SEED))
    out["ell_points"] = np.array(ell_pts, np.float32)
    out["ell_valid"] = np.array(ell_valid, bool)
    both_pts = np.concatenate([out["multi_points"], out["ell_points"]])
    both_valid = np.concatenate([out["multi_valid"], out["ell_valid"]])

    def put(prefix, poses, found):
        out[f"{prefix}_poses"] = np.asarray(poses, np.float32)
        out[f"{prefix}_found"] = np.asarray(found, bool)

    _, dcfg = asset_configs()
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        put(f"direct_{tag}", *jax_step(
            jax_asset_model(dtype=dtype), dcfg, out["multi_points"],
            out["multi_valid"], k=4,
        ))
    multi_images = np.asarray(
        range_view_project_batch(jnp.asarray(pts), spec, jnp.asarray(valid))
    )
    out["bf16_fcn_prob"], out["bf16_fcn_reg"] = fcn_golden_sample(
        jax_forward(jax_asset_model(dtype="bfloat16"), multi_images)
    )
    for tag, asset in (("mixed", MIXED_ASSET), ("yaw", YAW_ASSET)):
        put(tag, *jax_step(
            jax_asset_model(asset), asset_configs(asset)[1], both_pts, both_valid, k=4
        ))

    images = multi_images[:2]
    gt2 = {k: np.asarray(v)[:2] for k, v in gt.items()}
    ypred = corner_label_ypred(images, gt2)
    out["corner_ypred"] = ypred
    y, im = jnp.asarray(ypred), jnp.asarray(images)
    decode_batch = jax.jit(decode_batch, static_argnums=(2, 3))
    single = decode_batch(y, im, spec, DecodeConfig())
    put("corner", single["pose"], single["found"])
    out["corner_overflow"] = np.asarray(single["vote_overflow"], bool)
    multi = jax.jit(decode_batch_multi, static_argnums=(2, 3, 4))(
        y, im, spec, DecodeConfig(), 4
    )
    put("corner_multi", multi["poses"], multi["found"])
    out["corner_multi_overflow"] = np.asarray(multi["vote_overflow"], bool)
    small = decode_batch(
        y, im, spec, DecodeConfig(max_candidates=CORNER_MAX_CANDIDATES_SMALL)
    )
    put("corner_k64", small["pose"], small["found"])
    out["corner_k64_overflow"] = np.asarray(small["vote_overflow"], bool)

    hcfg, harrays = hybrid_corner_arrays()
    for tag, dtype, k in (("k1", "float32", 1), ("k4", "float32", 4), ("bf16_k4", "bfloat16", 4)):
        hmodel = jax_model_from_arrays(dataclasses.replace(hcfg, dtype=dtype), harrays)
        put(f"hybrid_{tag}", *jax_step(
            hmodel, dcfg, out["multi_points"], out["multi_valid"], k=k, head="corner"
        ))
    for key in ("deconv5b/kernel", "deconv6b/kernel"):
        out[f"hybrid/{key}"] = harrays[key]

    bcfg, barrays = bench_net_arrays()  # the corner row: the default ModelConfig
    put("bench_corner", *jax_step(
        jax_model_from_arrays(bcfg, barrays), DecodeConfig(), out["multi_points"],
        out["multi_valid"], head="corner",
    ))
    out.update({f"bench_corner/{k}": v for k, v in barrays.items()})
    return out


def seeded_fcn_arrays(mcfg, seed: int) -> dict[str, np.ndarray]:
    """npz-style arrays of the JAX FCN's seeded init (nnx.Rngs(seed))."""
    import jax
    from flax import nnx

    from tpufusion.models.fcn import FCN

    state = jax.jit(
        lambda: nnx.to_pure_dict(nnx.state(FCN(mcfg, in_channels=3, rngs=nnx.Rngs(seed))))
    )()
    return {
        f"{layer}/{leaf}": np.asarray(v, np.float32)
        for layer, leaves in state.items()
        for leaf, v in leaves.items()
    }


def jax_fusion_asset(dtype: str):
    """The JAX FusionNet the reference's fused benchmark builds, with the
    shipped asset's weights, computing in `dtype`."""
    import json

    from flax import nnx

    from tests.torch_golden import FUSION_ASSET
    from tpufusion.config import ModelConfig
    from tpufusion.models.fusion import FusionNet
    from tpufusion.models.io import load_state_npz

    with open(FUSION_ASSET + ".json") as f:
        meta = json.load(f)
    net = FusionNet(
        lidar_model=ModelConfig(dtype=dtype),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype=dtype),
        lidar_pool=tuple(meta["lidar_pool"]), cam_pool=tuple(meta["cam_pool"]),
        rngs=nnx.Rngs(2),
    )
    load_state_npz(FUSION_ASSET, net)
    return net


def jax_config3_seg(bev_fcn, points, valid, cam_img) -> np.ndarray:
    """The seg output of the reference's fused benchmark step."""
    import jax.numpy as jnp

    from tests.torch_golden import jax_apply
    from tpufusion.config import BevSpec
    from tpufusion.geometry.bev import bev_rasterize_batch
    from tpufusion.geometry.camera import rgb_onto_bev, synthetic_camera

    cam = synthetic_camera(1368, 512, 1400.0)
    spec = BevSpec(with_height_channel=True, with_intensity_channel=False)
    hc, wc, nx, ny = cam.height, cam.width, spec.nx, spec.ny
    vv = np.broadcast_to(np.arange(hc, dtype=np.float32)[:, None, None], (hc, wc, 1))
    uu = np.broadcast_to(np.arange(wc, dtype=np.float32)[None, :, None], (hc, wc, 1))
    v_t = jnp.asarray(rgb_onto_bev(vv, cam, nx, ny)[..., 0].astype(np.int32))
    u_t = jnp.asarray(rgb_onto_bev(uu, cam, nx, ny)[..., 0].astype(np.int32))
    ok_t = jnp.asarray(rgb_onto_bev(np.ones((hc, wc, 1), np.float32), cam, nx, ny)[..., 0] > 0)

    def fn(model, points, valid, cam_img):
        bev = bev_rasterize_batch(points, spec, valid)
        painted = jnp.where(ok_t, cam_img[:, v_t, u_t, 0], 0.0)
        fused = jnp.concatenate([bev, painted[..., None]], axis=-1)
        fused = jnp.swapaxes(fused, 1, 2)[:, :, : nx - 2, :]
        return model(fused, train=False)

    return jax_apply(bev_fcn, fn, points, valid, cam_img)


def golden_fusion_arrays() -> dict[str, np.ndarray]:
    import jax.numpy as jnp

    from tests.torch_golden import jax_apply, jax_model_from_arrays
    from tpufusion.config import BevSpec, ModelConfig, RangeViewSpec
    from tpufusion.geometry.bev import bev_rasterize_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch import _golden
    from tpufusion_torch.config import BevSpec as PortBevSpec

    out: dict[str, np.ndarray] = {}
    pts, valid = _golden.bev_golden_inputs(PortBevSpec())
    out["bev_points"], out["bev_valid"] = pts, valid
    bev = np.asarray(bev_rasterize_batch(jnp.asarray(pts), BevSpec(), jnp.asarray(valid)))
    out["bev_index"], out["bev_values"] = _golden.sparse_cells(bev)

    data = _golden.fusion_golden_data("cpu")
    out["fusion_points"], out["fusion_valid"] = data["points"], data["valid"]
    out["fusion_radar"], out["fusion_cam_sha256"] = data["radar"], data["cam_sha256"]
    lidar = range_view_project_batch(
        jnp.asarray(data["points"]), RangeViewSpec(), jnp.asarray(data["valid"]), "exact"
    )
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        centroid, rz = jax_apply(
            jax_fusion_asset(dtype), lambda m, c, l, r: m(c, l, r, train=False),
            data["cam"], lidar, data["radar"],
        )
        out[f"fusion_{tag}_centroid"], out[f"fusion_{tag}_rz"] = centroid, rz

    bcfg = ModelConfig(dtype="bfloat16")
    barrays = seeded_fcn_arrays(bcfg, 1)
    out.update({f"bev_fcn/{k}": v for k, v in barrays.items()})
    n = _golden.SEG_FRAMES
    seg = jax_config3_seg(
        jax_model_from_arrays(bcfg, barrays), data["points"][:n], data["valid"][:n],
        data["cam"][:n],
    )
    out["seg_prob"] = _golden.seg_golden_sample(seg)
    return out


def jax_train_case(case: str, batch: dict, multi_golden: dict) -> dict[str, np.ndarray]:
    """The reference's train step for a TRAIN_CASES entry: its labels,
    `make_train_step`'s loss, metrics and BatchNorm statistics, and the
    gradients of the same loss on a second copy of the model."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import nnx

    from tests.torch_golden import ASSET, asset_configs, jax_model_from_arrays, load_npz
    from tpufusion.config import LossConfig, RangeViewSpec, TrainConfig
    from tpufusion.data.augment import roll_frame, sample_roll
    from tpufusion.geometry.encoding import encode_direct_label_batch, encode_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.models.losses import weighted_pose_loss
    from tpufusion.train.train_step import make_train_step
    from tpufusion_torch import _golden

    what = _golden.TRAIN_CASES[case]
    mcfg, dcfg = asset_configs()
    arrays = load_npz(ASSET)
    if what["head"] == "corner":
        arrays = _golden.hybrid_corner_arrays(arrays, multi_golden)
    mcfg = dataclasses.replace(mcfg, head=what["head"], dtype=what["dtype"])
    spec = RangeViewSpec()
    jb = {k: jnp.asarray(batch[k]) for k in ("points", "valid", "center", "size", "yaw")}
    images = range_view_project_batch(jb["points"], spec, jb["valid"])
    if what["head"] == "direct":
        labels = jax.jit(
            lambda c, s, y, im: encode_direct_label_batch(
                c, s, y, im, spec, yaw_frame=dcfg.direct_yaw_frame)
        )(jb["center"], jb["size"], jb["yaw"], images)
    else:
        labels = jax.jit(lambda c, s, y, im: encode_label_batch(c, s, y, im, spec))(
            jb["center"], jb["size"], jb["yaw"], images)
    out = {}
    key = jax.random.PRNGKey(_golden.TRAIN_SHIFT_SEED)
    if what["augment"]:
        # augment_batch's own draws: one key a frame, split from the step's
        keys = jax.random.split(key, len(batch["points"]))
        shifts = jax.vmap(lambda k, c, s, y: sample_roll(k, c, s, y, spec))(
            keys, jb["center"], jb["size"], jb["yaw"])
        out["shifts"] = np.asarray(shifts, np.int64)
        images, labels = jax.vmap(roll_frame)(images, labels, shifts)
    out["label_index"], out["label_values"] = _golden.sparse_labels(np.asarray(labels))

    tcfg = TrainConfig(batch_size=len(batch["points"]), augment=what["augment"])
    model = jax_model_from_arrays(mcfg, arrays)
    step = make_train_step(spec, LossConfig(), tcfg, head=what["head"],
                           yaw_frame=dcfg.direct_yaw_frame)
    opt = nnx.Optimizer(model, optax.adam(_golden.TRAIN_LR), wrt=nnx.Param)
    _, metrics = step(model, opt, jb, key)
    for k, v in metrics.items():
        out[k] = np.asarray(v, np.float32)
    out["norm_mean"] = np.asarray(model.norm.mean[...])
    out["norm_var"] = np.asarray(model.norm.var[...])

    fresh = jax_model_from_arrays(mcfg, arrays)

    @nnx.jit
    def grads_of(m, images, labels):
        return nnx.grad(
            lambda m: weighted_pose_loss(m(images, train=True), labels, LossConfig()))(m)

    grads = nnx.to_pure_dict(grads_of(fresh, images, labels))
    for layer, leaves in grads.items():
        for leaf, g in leaves.items():
            g = np.asarray(g, np.float32)
            exact = what["dtype"] == "bfloat16" and not (g.view(np.uint32) & 0xFFFF).any()
            out[f"grad/{layer}/{leaf}"] = _golden.bf16_bits(g) if exact else g
    return out


def jax_fusion_step(dtype: str, data: dict, lidar) -> dict[str, np.ndarray]:
    """One fusion step's loss, gradients (sampled) and BatchNorm
    statistics from the reference: the shipped asset, train=True, every
    dropout rate 0."""
    import jax.numpy as jnp
    from flax import nnx

    from tpufusion.models.fusion import fusion_loss
    from tpufusion_torch import _golden

    net = jax_fusion_asset(dtype)
    for branch in (net.cam_branch, net.lidar_branch):
        branch.dropout1.rate = branch.dropout2.rate = 0.0

    @nnx.jit
    def run(net, cam, lidar, radar, centroid, rz):
        return nnx.value_and_grad(
            lambda n: fusion_loss(n(cam, lidar, radar, train=True), (centroid, rz)),
            argnums=nnx.DiffState(0, nnx.Param))(net)

    loss, grads = run(net, *(jnp.asarray(a) for a in (
        data["cam"], lidar, data["radar"], data["centroid"], data["rz"])))
    out = {"loss": np.asarray(loss, np.float32)}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v, np.float32)

    for key, g in walk(nnx.to_pure_dict(grads)):
        out[f"grad/{key}"] = _golden.grad_sample(g)
        out[f"grad_max/{key}"] = np.asarray(np.abs(g).max(), np.float32)
    for name in ("lidar_fcn", "camera_fcn"):
        norm = getattr(net, name).norm
        out[f"stats/{name}/norm/mean"] = np.asarray(norm.mean[...])
        out[f"stats/{name}/norm/var"] = np.asarray(norm.var[...])
    return out


def golden_train_arrays(with_fusion: bool = True, previous: dict | None = None) -> dict:
    """The train golden. with_fusion=False copies the fusion steps from
    `previous` (the file as it is) instead of computing them again."""
    import jax.numpy as jnp

    from tests.torch_golden import GOLDEN_MULTI, load_npz
    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch import _golden

    batch = _golden.train_golden_inputs()
    gm = load_npz(GOLDEN_MULTI)
    out: dict[str, np.ndarray] = {"inputs_sha256": batch["sha256"]}
    for case in _golden.TRAIN_CASES:
        out.update({f"{case}/{k}": v for k, v in jax_train_case(case, batch, gm).items()})
    if not with_fusion:
        out.update({k: v for k, v in (previous or {}).items() if k.startswith("fusion_")})
        return out
    data = _golden.fusion_golden_data("cpu")
    lidar = np.asarray(range_view_project_batch(
        jnp.asarray(data["points"]), RangeViewSpec(), jnp.asarray(data["valid"]), "exact"))
    for tag, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        out.update({f"fusion_{tag}/{k}": v for k, v in jax_fusion_step(dtype, data, lidar).items()})
    return out


def write_train_golden() -> None:
    from tests.torch_golden import GOLDEN_TRAIN

    train = golden_train_arrays()
    np.savez_compressed(GOLDEN_TRAIN, **train)
    print(f"wrote {GOLDEN_TRAIN} ({os.path.getsize(GOLDEN_TRAIN)} bytes)")
    for key in sorted(train):
        if key.endswith("/loss"):
            print(f"  {key}: {float(train[key]):.6f}")


def golden_viewer_arrays() -> dict[str, np.ndarray]:
    """cv2's JPEG bytes of the viewer golden's frames (OpenCV with its
    libjpeg-turbo, imported here only)."""
    import cv2

    from tpufusion_torch._golden import VIEWER_QUALITY, viewer_frame_digest, viewer_golden_frames

    frames = viewer_golden_frames()
    out = {"frame_sha256": np.array([viewer_frame_digest(f) for f in frames])}
    for i, frame in enumerate(frames):
        ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, VIEWER_QUALITY])
        assert ok
        out[f"jpeg_{i}"] = np.frombuffer(bytes(buf), np.uint8)
    return out


def write_viewer_golden() -> None:
    from tests.torch_golden import GOLDEN_VIEWER

    np.savez_compressed(GOLDEN_VIEWER, **golden_viewer_arrays())
    print(f"wrote {GOLDEN_VIEWER} ({os.path.getsize(GOLDEN_VIEWER)} bytes)")


def jax_tall_step(points: np.ndarray, valid: np.ndarray, k: int = 1):
    """JAX make_e2e_step(head="direct", max_obstacles=k) with the shipped
    asset in float32 at the tall golden's 63 x 1801 spec -> (poses, found)
    as numpy."""
    import jax.numpy as jnp
    from flax import nnx

    from tests.torch_golden import asset_configs, jax_asset_model, to_jax_config
    from tpufusion.config import RangeViewSpec
    from tpufusion.predict import make_e2e_step
    from tpufusion_torch._golden import TALL_RES_V_DEG

    _, dcfg = asset_configs()
    graphdef, state = nnx.split(jax_asset_model())
    step = make_e2e_step(graphdef, RangeViewSpec(res_v_deg=TALL_RES_V_DEG),
                         to_jax_config(dcfg), max_obstacles=k, head="direct")
    poses, found = step(state, jnp.asarray(points), jnp.asarray(valid))
    return np.asarray(poses), np.asarray(found)


def golden_tall_arrays() -> dict[str, np.ndarray]:
    """The tall golden: the 64-beam frames and JAX's answer on them."""
    from tpufusion_torch._golden import TALL_BEAMS, TALL_FRAMES, TALL_POINTS, TALL_SEED
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    points, _, valid = synthesize_beam_scan_batch(
        np.random.default_rng(TALL_SEED), TALL_FRAMES, TALL_POINTS, n_beams=TALL_BEAMS)
    poses, found = jax_tall_step(points, valid)
    return {"points": points, "valid": valid, "found": found.astype(bool),
            "poses": poses.astype(np.float32)}


def write_tall_golden() -> None:
    from tests.torch_golden import REPO

    path = os.path.join(REPO, "tests", "data", "torch_port_golden_tall.npz")
    tall = golden_tall_arrays()
    np.savez_compressed(path, **tall)
    print(f"wrote {path} ({os.path.getsize(path)} bytes): found {tall['found'].astype(int).tolist()}")


def golden_flagship_arrays() -> dict[str, np.ndarray]:
    """The bench golden's bench.py part: the headline net and JAX's
    answers on BENCH_FRAMES beam scans."""
    import jax.numpy as jnp

    from bench import FLAGSHIP
    from tests.torch_golden import jax_beam_scans, jax_forward, jax_model_from_arrays, jax_step
    from tpufusion.config import DEFAULT
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch._golden import BENCH_FRAMES, BENCH_SEED, flagship_prob_sample

    points, valid = jax_beam_scans(BENCH_SEED, BENCH_FRAMES)
    out = {"points": points, "valid": valid}
    mcfg, arrays = bench_net_arrays(**FLAGSHIP)
    out.update({f"flagship/{k}": v for k, v in arrays.items()})
    images = np.asarray(range_view_project_batch(
        jnp.asarray(points), DEFAULT.range_view, jnp.asarray(valid)))
    for tag, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        model = jax_model_from_arrays(dataclasses.replace(mcfg, dtype=dtype), arrays)
        poses, found = jax_step(model, DEFAULT.decode, points, valid)
        out[f"flagship_{tag}_poses"] = poses.astype(np.float32)
        out[f"flagship_{tag}_found"] = found.astype(bool)
        out[f"flagship_{tag}_prob"], out[f"flagship_{tag}_prob_max"] = flagship_prob_sample(
            jax_forward(model, images))
    return out


def golden_entry_arrays() -> dict[str, np.ndarray]:
    """The bench golden's `__graft_entry__.entry()` part: its state, its
    example points and its fn's answer on them."""
    from flax import nnx

    import __graft_entry__

    # entry()'s fn eagerly, whose arithmetic the port's is: under jax.jit
    # XLA contracts the projection's x*x + y*y into an FMA (ROADMAP Queue
    # 3), which moves 1,568 distances of the example an ulp and changes
    # two pixels' winners, and frame 3's pose 0.078 m
    fn, (state, entry_points) = __graft_entry__.entry()
    poses, found = fn(state, entry_points)
    out = {f"entry/{layer}/{leaf}": np.asarray(v, np.float32)
           for layer, leaves in nnx.to_pure_dict(state).items() for leaf, v in leaves.items()}
    out["entry_points"] = np.array(entry_points, np.float32)
    out["entry_poses"] = np.asarray(poses, np.float32)
    out["entry_found"] = np.asarray(found, bool)
    return out


def write_bench_golden() -> None:
    from tests.torch_golden import GOLDEN_BENCH

    bench = {**golden_flagship_arrays(), **golden_entry_arrays()}
    np.savez_compressed(GOLDEN_BENCH, **bench)
    print(f"wrote {GOLDEN_BENCH} ({os.path.getsize(GOLDEN_BENCH)} bytes)")
    for key in sorted(bench):
        if key.endswith(("found", "prob_max")):
            print(f"  {key}: {bench[key].tolist()}")


PROJECTION_METHODS = ("exact", "pallas", "scatter", "sort16", "packed")


def jax_method_images(points: np.ndarray, valid: np.ndarray) -> dict[str, np.ndarray]:
    """JAX range_view_project_batch (eager) under each projection method
    whose limits the frames meet; a method whose asserts refuse them is
    left out."""
    import jax.numpy as jnp

    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.range_view import range_view_project_batch

    out = {}
    for m in PROJECTION_METHODS:
        try:
            out[m] = np.asarray(range_view_project_batch(
                jnp.asarray(points), RangeViewSpec(), jnp.asarray(valid), m))
        except AssertionError:  # sort16 past 2**15 points
            assert m == "sort16" and points.shape[1] > 2**15, m
    return out


def jax_packed_step(points: np.ndarray, valid: np.ndarray):
    """JAX make_e2e_step(method="packed", head="direct") with the shipped
    asset in float32 -> (poses, found) as numpy."""
    import jax.numpy as jnp
    from flax import nnx

    from tests.torch_golden import asset_configs, jax_asset_model, to_jax_config
    from tpufusion.config import RangeViewSpec
    from tpufusion.predict import make_e2e_step

    graphdef, state = nnx.split(jax_asset_model())
    step = make_e2e_step(graphdef, RangeViewSpec(), to_jax_config(asset_configs()[1]), "packed",
                         head="direct")
    poses, found = step(state, jnp.asarray(points), jnp.asarray(valid))
    return np.asarray(poses), np.asarray(found)


def golden_packed_arrays(images: dict | None = None, step=None) -> dict[str, np.ndarray]:
    """The packed golden from the near-tie sets; `images` ({prefix: JAX's
    images by method}) and `step` (JAX's packed step on the long set) are
    computed when not given."""
    from tests.torch_golden import GOLDEN_BENCH, image_digest, load_npz
    from tpufusion_torch._golden import frames_digest, near_tie_sets

    bench = load_npz(GOLDEN_BENCH)
    sets = near_tie_sets(bench["points"], bench["valid"])
    images = images or {k: jax_method_images(*pv) for k, pv in sets.items()}
    poses, found = step or jax_packed_step(*sets[""])
    out = {}
    for k, (points, valid) in sets.items():
        out[f"{k}frames_sha256"] = np.array(frames_digest(points, valid))
        for m, ims in images[k].items():
            out[f"{k}{m}_sha256"] = np.array([image_digest(im) for im in ims])
        out[f"{k}packed_exact_pixels"] = (
            images[k]["packed"] != images[k]["exact"]).any(-1).sum((1, 2))
    out["sort16_refused"] = np.array("sort16" not in images[""])
    out["packed_step_found"] = found.astype(bool)
    out["packed_step_poses"] = poses.astype(np.float32)
    return out


def write_packed_golden() -> None:
    from tests.torch_golden import GOLDEN_PACKED

    packed = golden_packed_arrays()
    if not (packed["packed_exact_pixels"].all() and packed["short_packed_exact_pixels"].all()):
        raise SystemExit("the near-tie frames do not tell 'packed' from 'exact' on every frame")
    np.savez_compressed(GOLDEN_PACKED, **packed)
    print(f"wrote {GOLDEN_PACKED} ({os.path.getsize(GOLDEN_PACKED)} bytes): packed differs from "
          f"exact in {packed['packed_exact_pixels'].tolist()} pixels "
          f"({packed['short_packed_exact_pixels'].tolist()} on the short set), packed step "
          f"found {packed['packed_step_found'].astype(int).tolist()}")


def golden_bf16_arrays() -> dict[str, np.ndarray]:
    """The bf16 golden: the frames, the two assets' bf16 FCN outputs and
    JAX's direct decode of them for every BF16_DECODE_CASES entry."""
    import jax
    import jax.numpy as jnp

    from tests.torch_golden import (
        ASSETS,
        GOLDEN_MULTI,
        jax_asset_model,
        jax_forward,
        to_jax_config,
    )
    from tpufusion.config import RangeViewSpec
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch._golden import (
        BF16_DECODE_CASES,
        BF16_DECODE_FCNS,
        BF16_DECODE_K,
        bf16_bits,
        bf16_decode_case,
    )

    with np.load(GOLDEN_MULTI) as z:
        points = np.concatenate([z["multi_points"][:1], z["ell_points"][:1]])
        valid = np.concatenate([z["multi_valid"][:1], z["ell_valid"][:1]])
    images = np.asarray(range_view_project_batch(jnp.asarray(points), RangeViewSpec(),
                                                 jnp.asarray(valid)))
    out = {"images": images}
    y_bf16 = {}
    for key, name in BF16_DECODE_FCNS.items():
        y = jnp.asarray(jax_forward(jax_asset_model(os.path.join(ASSETS, name)), images))
        y_bf16[key] = y.astype(jnp.bfloat16)
        out[f"{key}_bits"] = bf16_bits(np.asarray(y_bf16[key].astype(jnp.float32)))
    decode = jax.jit(decode_batch_direct, static_argnums=(2, 3, 4))
    for case in BF16_DECODE_CASES:
        fcn, cfg = bf16_decode_case(case, ASSETS)
        got = decode(y_bf16[fcn], jnp.asarray(images), RangeViewSpec(), to_jax_config(cfg),
                     BF16_DECODE_K)
        out[f"{case}_poses"] = np.asarray(got["poses"], np.float32)
        out[f"{case}_found"] = np.asarray(got["found"], bool)
    return out


def write_bf16_golden() -> None:
    from tests.torch_golden import GOLDEN_BF16

    arrays = golden_bf16_arrays()
    np.savez_compressed(GOLDEN_BF16, **arrays)
    print(f"wrote {GOLDEN_BF16} ({os.path.getsize(GOLDEN_BF16)} bytes): found "
          + ", ".join(f"{k[:-6]} {arrays[k].astype(int).tolist()}" for k in sorted(arrays)
                      if k.endswith("_found")))


def golden_f16_arrays() -> dict[str, np.ndarray]:
    """The float16 golden: the two assets' FCN outputs rounded to float16
    on the bf16 golden's images with JAX's direct decode of them for every
    F16_DECODE_CASES entry, JAX's float16 FCN sample and float16 e2e step
    on the multi golden's two-vehicle frames."""
    import jax
    import jax.numpy as jnp

    from tests.torch_golden import (
        ASSETS,
        GOLDEN_BF16,
        GOLDEN_MULTI,
        asset_configs,
        jax_asset_model,
        jax_forward,
        jax_step,
        to_jax_config,
    )
    from tpufusion.config import RangeViewSpec
    from tpufusion.decode.decode import decode_batch_direct
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch._golden import (
        BF16_DECODE_FCNS,
        F16_DECODE_CASES,
        F16_DECODE_K,
        F16_E2E_K,
        bf16_decode_case,
        f16_bits,
        fcn_golden_sample,
    )

    with np.load(GOLDEN_BF16) as z:
        images = z["images"]
    out = {}
    y_f16 = {}
    for key, name in BF16_DECODE_FCNS.items():
        y = jnp.asarray(jax_forward(jax_asset_model(os.path.join(ASSETS, name)), images))
        y_f16[key] = y.astype(jnp.float16)
        out[f"{key}_bits"] = f16_bits(np.asarray(y_f16[key].astype(jnp.float32)))
    decode = jax.jit(decode_batch_direct, static_argnums=(2, 3, 4))
    for case in F16_DECODE_CASES:
        fcn, cfg = bf16_decode_case(case, ASSETS, F16_DECODE_CASES)
        for k, tag in ((F16_DECODE_K, case), (1, f"{case}_k1")):
            got = decode(y_f16[fcn], jnp.asarray(images), RangeViewSpec(), to_jax_config(cfg), k)
            out[f"{tag}_poses"] = np.asarray(got["poses"], np.float32)
            out[f"{tag}_found"] = np.asarray(got["found"], bool)
    with np.load(GOLDEN_MULTI) as z:
        points, valid = z["multi_points"], z["multi_valid"]
    multi_images = np.asarray(range_view_project_batch(jnp.asarray(points), RangeViewSpec(),
                                                       jnp.asarray(valid)))
    prob, reg = fcn_golden_sample(jax_forward(jax_asset_model(dtype="float16"), multi_images))
    out["fcn_prob"], out["fcn_reg_bits"] = prob, f16_bits(reg)
    poses, found = jax_step(jax_asset_model(dtype="float16"), asset_configs()[1], points, valid,
                            k=F16_E2E_K)
    out["e2e_poses"], out["e2e_found"] = np.asarray(poses, np.float32), np.asarray(found, bool)
    return out


def write_f16_golden() -> None:
    from tests.torch_golden import GOLDEN_F16

    arrays = golden_f16_arrays()
    np.savez_compressed(GOLDEN_F16, **arrays)
    print(f"wrote {GOLDEN_F16} ({os.path.getsize(GOLDEN_F16)} bytes): found "
          + ", ".join(f"{k[:-6]} {arrays[k].astype(int).tolist()}" for k in sorted(arrays)
                      if k.endswith("_found")))


def golden_f8_arrays() -> dict[str, np.ndarray]:
    """The small-float golden: JAX's FCN sample in each format on the
    multi golden's first two frames, and JAX's e2e step in
    F8_E2E_FORMATS on its three."""
    import jax.numpy as jnp

    from tests.torch_golden import (
        GOLDEN_MULTI,
        asset_configs,
        jax_apply,
        jax_asset_model,
        jax_forward,
        jax_step,
    )
    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch._golden import F8_E2E_FORMATS, F8_E2E_K, F8_FRAMES, small_float_sample
    from tpufusion_torch.ops.small_float import FORMATS

    with np.load(GOLDEN_MULTI) as z:
        points, valid = z["multi_points"], z["multi_valid"]
    images = np.asarray(range_view_project_batch(
        jnp.asarray(points[:F8_FRAMES]), RangeViewSpec(), jnp.asarray(valid[:F8_FRAMES])))
    out = {}
    for name in FORMATS:
        model = jax_asset_model(dtype=name)
        features = np.asarray(jax_apply(model, lambda m, x: m.features(x), images))
        codes, prob = small_float_sample(features.view(np.uint8), jax_forward(model, images))
        out[f"{name}_features"], out[f"{name}_prob"] = codes, prob
    for name in F8_E2E_FORMATS:
        poses, found = jax_step(jax_asset_model(dtype=name), asset_configs()[1], points, valid,
                                k=F8_E2E_K)
        out[f"e2e_{name}_poses"] = np.asarray(poses, np.float32)
        out[f"e2e_{name}_found"] = np.asarray(found, bool)
    return out


def write_f8_golden() -> None:
    from tests.torch_golden import GOLDEN_F8

    arrays = golden_f8_arrays()
    np.savez_compressed(GOLDEN_F8, **arrays)
    print(f"wrote {GOLDEN_F8} ({os.path.getsize(GOLDEN_F8)} bytes): found "
          + ", ".join(f"{k[:-6]} {arrays[k].astype(int).tolist()}" for k in sorted(arrays)
                      if k.endswith("_found")))


def jax_f8_grads(name: str, images: np.ndarray, labels: np.ndarray) -> dict[str, np.ndarray]:
    """JAX's loss and gradients of the shipped asset's FCN in `name` on
    (images, labels), train=True, LossConfig(**F8_GRAD_LOSS): {"loss",
    "<layer>/<param>"}, float32."""
    import jax
    from flax import nnx

    from tests.torch_golden import jax_asset_model
    from tpufusion.config import LossConfig
    from tpufusion.models.losses import weighted_pose_loss
    from tpufusion_torch._golden import F8_GRAD_LOSS

    graphdef, state = nnx.split(jax_asset_model(dtype=name))
    loss_cfg = LossConfig(**F8_GRAD_LOSS)

    def value_and_grad(state, images, labels):
        model = nnx.merge(graphdef, state)
        return nnx.value_and_grad(
            lambda m: weighted_pose_loss(m(images, train=True), labels, loss_cfg))(model)

    loss, grads = jax.jit(value_and_grad)(state, images, labels)
    out = {"loss": np.asarray(loss, np.float32)}
    for path, g in nnx.to_flat_state(grads):
        out["/".join(map(str, path))] = np.asarray(g, np.float32)
    return out


def f8_grad_inputs() -> tuple[dict, np.ndarray, np.ndarray]:
    """(the golden's batch, JAX's range views of it, JAX's direct-head
    labels in the asset's yaw frame)."""
    import jax.numpy as jnp

    from tests.torch_golden import asset_configs
    from tpufusion.config import RangeViewSpec
    from tpufusion.geometry.encoding import encode_direct_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion_torch._golden import F8_GRAD_FRAMES, F8_GRAD_SEED
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch

    points, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(F8_GRAD_SEED),
                                                   F8_GRAD_FRAMES, 32768)
    batch = {"points": points, "valid": valid, **{k: gt[k] for k in ("center", "size", "yaw")}}
    spec = RangeViewSpec()
    images = range_view_project_batch(jnp.asarray(points), spec, jnp.asarray(valid))
    labels = encode_direct_label_batch(
        *(jnp.asarray(gt[k]) for k in ("center", "size", "yaw")), images, spec,
        yaw_frame=asset_configs()[1].direct_yaw_frame)
    return batch, np.asarray(images), np.asarray(labels)


def golden_f8_grad_arrays(names=None) -> dict[str, np.ndarray]:
    """The small-float gradient golden (`_golden.py`, F8_GRAD_*): the batch
    and JAX's loss and gradients in each of `names` (every format)."""
    from tpufusion_torch.ops.small_float import FORMATS

    batch, images, labels = f8_grad_inputs()
    out = dict(batch)
    for name in names or FORMATS:
        out.update({f"{name}/{k}": v for k, v in jax_f8_grads(name, images, labels).items()})
    return out


def write_f8_grad_golden() -> None:
    from tests.torch_golden import GOLDEN_F8_GRAD

    arrays = golden_f8_grad_arrays()
    np.savez_compressed(GOLDEN_F8_GRAD, **arrays)
    print(f"wrote {GOLDEN_F8_GRAD} ({os.path.getsize(GOLDEN_F8_GRAD)} bytes): losses "
          + ", ".join(f"{k[:-5]} {float(arrays[k]):.6g}" for k in sorted(arrays)
                      if k.endswith("/loss")))


def f8_mesh_arrays(name: str | None = None, norm: bool = False) -> dict[str, np.ndarray]:
    """npz-style float32 arrays of the mesh golden's FCN in `name`
    (`_golden.f8_mesh_config`): the port's `FCN(..., seed=F8_MESH_SEED)`."""
    from tpufusion_torch._golden import F8_MESH_NAME, F8_MESH_SEED, f8_mesh_config
    from tpufusion_torch.models.fcn import FCN

    model = FCN(f8_mesh_config(name or F8_MESH_NAME, norm), seed=F8_MESH_SEED)
    return {k.replace(".", "/"): v.numpy() for k, v in model.state_dict().items()}


def jax_f8_mesh_step(ranks: int, n_spatial: int, name: str | None = None, norm: bool = False,
                     inputs=None) -> dict[str, np.ndarray]:
    """JAX's train step of the mesh golden's FCN in `name` on a mesh of
    `ranks` virtual CPU devices (`n_spatial` spatial), optax's SGD at a
    rate of 1: {"loss", "<layer>/<param>": the gradient}, the gradient
    read back from each parameter's move (a small float's snapped to the
    format: the move is the gradient within a float32 rounding of the
    parameter)."""
    import jax
    import optax
    import torch
    from flax import nnx

    from tests.torch_golden import jax_model_from_arrays
    from tpufusion.config import LossConfig, MeshConfig, RangeViewSpec, TrainConfig
    from tpufusion.parallel import mesh as jax_mesh
    from tpufusion.train import train_step as jax_train_step
    from tpufusion_torch._golden import F8_GRAD_LOSS, F8_MESH_NAME, f8_mesh_config, f8_mesh_inputs
    from tpufusion_torch.ops.small_float import FORMATS, round_small_float

    name = name or F8_MESH_NAME
    images, labels = inputs if inputs is not None else f8_mesh_inputs()
    cfg = f8_mesh_config(name, norm)
    arrays = f8_mesh_arrays(name, norm)
    jmesh = jax_mesh.make_mesh(MeshConfig(n_devices=ranks, n_spatial=n_spatial))
    model = jax_model_from_arrays(cfg, arrays)
    opt = nnx.Optimizer(model, optax.sgd(1.0), wrt=nnx.Param)
    for mod in (model, opt):
        nnx.update(mod, jax_mesh.replicate(nnx.state(mod), jmesh))
    step = jax_train_step.make_train_step(
        RangeViewSpec(res_h_deg=1.8), LossConfig(**F8_GRAD_LOSS), TrainConfig(augment=False),
        mesh=jmesh, head="direct", yaw_frame="local")
    sh = jax_mesh.batch_sharding(jmesh)
    batch = {"images": jax.device_put(images, sh), "labels": jax.device_put(labels, sh)}
    with jmesh:
        loss, _ = step(model, opt, batch, jax.random.PRNGKey(0))
    out = {"loss": np.asarray(loss, np.float32)}
    fmt = FORMATS[name]
    for path, p in nnx.to_flat_state(nnx.state(model, nnx.Param)):
        key = "/".join(map(str, path))
        move = arrays[key] - np.asarray(p, np.float32)
        if not key.startswith("norm/"):
            move = round_small_float(torch.from_numpy(move), fmt).numpy()
        out[key] = move
    return out


def golden_f8_mesh_arrays(layouts=None) -> dict[str, np.ndarray]:
    """The mesh golden (`_golden.py`, F8_MESH_*): each layout's loss and
    gradient codes, and a digest of the inputs."""
    import torch

    from tpufusion_torch._golden import F8_MESH_LAYOUTS, F8_MESH_NAME, _sha256, f8_mesh_inputs
    from tpufusion_torch.ops.small_float import FORMATS, encode

    inputs = f8_mesh_inputs()
    out = {"inputs_sha256": np.array(_sha256(*inputs))}
    for layout in layouts or F8_MESH_LAYOUTS:
        got = jax_f8_mesh_step(*F8_MESH_LAYOUTS[layout], inputs=inputs)
        out[f"{layout}/loss"] = got.pop("loss")
        for k, v in got.items():
            out[f"{layout}/{k}"] = encode(torch.from_numpy(v), FORMATS[F8_MESH_NAME]).to(
                torch.uint8).numpy()
    return out


def write_f8_mesh_golden() -> None:
    from tests.torch_golden import GOLDEN_F8_MESH

    arrays = golden_f8_mesh_arrays()
    np.savez_compressed(GOLDEN_F8_MESH, **arrays)
    print(f"wrote {GOLDEN_F8_MESH} ({os.path.getsize(GOLDEN_F8_MESH)} bytes): losses "
          + ", ".join(f"{k[:-5]} {float(arrays[k]):.6g}" for k in sorted(arrays)
                      if k.endswith("/loss")))


def main() -> None:
    if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.torch_golden import GOLDEN, GOLDEN_FUSION, GOLDEN_MULTI

    if sys.argv[1:] == ["train"]:
        write_train_golden()
        return
    if sys.argv[1:] == ["viewer"]:
        write_viewer_golden()
        return
    if sys.argv[1:] == ["tall"]:
        write_tall_golden()
        return
    if sys.argv[1:] == ["bench"]:
        write_bench_golden()
        return
    if sys.argv[1:] == ["packed"]:
        write_packed_golden()
        return
    if sys.argv[1:] == ["bf16"]:
        write_bf16_golden()
        return
    if sys.argv[1:] == ["f16"]:
        write_f16_golden()
        return
    if sys.argv[1:] == ["f8_mesh"]:
        write_f8_mesh_golden()
        return
    if sys.argv[1:] == ["f8_grad"]:
        write_f8_grad_golden()
        return
    if sys.argv[1:] == ["f8"]:
        write_f8_golden()
        return

    arrays = golden_arrays()
    if not arrays["found"].all():
        raise SystemExit(f"golden frames must all be detections: {arrays['found']}")
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(f"wrote {GOLDEN}: found {arrays['found']}, occupied {arrays['occupied']}")
    multi = golden_multi_arrays()
    np.savez_compressed(GOLDEN_MULTI, **multi)
    print(f"wrote {GOLDEN_MULTI} ({os.path.getsize(GOLDEN_MULTI)} bytes)")
    for key in sorted(multi):
        if key.endswith("found") or key.endswith("overflow"):
            print(f"  {key}: {multi[key].astype(int).tolist()}")
    fusion = golden_fusion_arrays()
    np.savez_compressed(GOLDEN_FUSION, **fusion)
    print(f"wrote {GOLDEN_FUSION} ({os.path.getsize(GOLDEN_FUSION)} bytes)")
    for tag in ("centroid", "rz"):
        gap = np.abs(fusion[f"fusion_f32_{tag}"] - fusion[f"fusion_bf16_{tag}"]).max()
        print(f"  JAX float32 vs bf16 {tag}: {gap:.4e}")
    write_train_golden()
    write_viewer_golden()
    write_tall_golden()
    write_bench_golden()
    write_packed_golden()
    write_bf16_golden()
    write_f16_golden()
    write_f8_golden()
    write_f8_grad_golden()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
