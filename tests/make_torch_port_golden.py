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

tests/test_torch_e2e.py and tests/test_torch_multi.py recompute both and
fail when a file is stale.

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
    state = jax.jit(
        lambda: nnx.to_pure_dict(nnx.state(FCN(mcfg, in_channels=3, rngs=nnx.Rngs(0))))
    )()
    arrays = {
        f"{layer}/{leaf}": np.asarray(v, np.float32)
        for layer, leaves in state.items()
        for leaf, v in leaves.items()
    }
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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tests.torch_golden import GOLDEN, GOLDEN_MULTI

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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
