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

tests/test_torch_e2e.py, tests/test_torch_multi.py and
tests/test_torch_fusion.py recompute them and fail when a file is stale.

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


def bench_corner_arrays() -> tuple:
    """(ModelConfig, arrays) of bench.py's corner row: default
    ModelConfig in bf16, seeded init (nnx.Rngs(0)), deconv6a bias
    [2, -2] (a background-leaning softmax, as a trained detector's)."""
    import jax
    from flax import nnx

    from tpufusion.config import ModelConfig
    from tpufusion.models.fcn import FCN

    mcfg = dataclasses.replace(ModelConfig(), dtype="bfloat16")
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

    bcfg, barrays = bench_corner_arrays()
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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.torch_golden import GOLDEN, GOLDEN_FUSION, GOLDEN_MULTI

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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
