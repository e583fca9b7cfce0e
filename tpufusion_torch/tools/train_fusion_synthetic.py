"""Train and evaluate the camera + lidar + radar FusionNet on aligned
synthetic data (counterpart of `tpufusion/tools/train_fusion_synthetic.py`).

Does fusing camera and radar with lidar beat lidar alone on centroid and
rz error? Protocol, as in the reference:

  * aligned frames from `data.synthetic.build_fusion_dataset`: beam scans
    with the vehicle inside the camera's field of view, a synthetic
    pinhole rendering it at the full 512 x 1368 crop, radar reporting the
    cluster's noisy (range, angle), three offset timestamp streams joined
    by `data.align` (training frames from numpy seed 11, held-out frames
    from seed 999);
  * two nets with the same architecture, initial weights (seed 3), data
    and order train on the same frames: "fused" sees all three
    modalities, "lidar_only" sees the camera and radar zeroed;
  * both evaluate on the held-out frames; the fused net is written as a
    float16 asset (`models.io.fusion_from_asset` loads it) and the table
    of both into its json, merged over an earlier run's results.

    python -m tpufusion_torch.tools.train_fusion_synthetic [--epochs 25] [--device cuda]

Datasets are cached under `--cache_dir`, keyed by frames, seed, the
range view, the camera and a version tag of the port's own: the
reference's cache holds other bits for the same key (its scenes come from
`jax.random`), so neither tool ever loads the other's file. The asset
goes to `tpufusion_torch/assets/fusion_net.npz` (+ .json) unless `--out`
names another path outside the JAX package.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import numpy as np
import torch

from tpufusion_torch.config import CameraConfig, ModelConfig, RangeViewSpec
from tpufusion_torch.data.synthetic import build_fusion_dataset
from tpufusion_torch.geometry.camera import CameraModel, synthetic_camera
from tpufusion_torch.models.fusion import FusionNet, init_fusion_
from tpufusion_torch.models.io import save_state_npz
from tpufusion_torch.tools import ASSETS, refuse_reference_path
from tpufusion_torch.train.fusion_trainer import train_fusion

ASSET = os.path.join(ASSETS, "fusion_net.npz")
CACHE_DIR = os.path.join(ASSETS, "fusion_ds_cache")
# the reference's full camera geometry (512 x 1368 crop); feature pooling
# keeps the dense branches asset-sized
CAM = CameraConfig(width=1368, height=512, crop_top=0)
LIDAR_POOL = (2, 8)
CAM_POOL = (8, 8)
# bump when the generators change: it invalidates cached datasets. Not the
# reference's tag ("v1"), whose cache holds jax.random's scenes.
_DATASET_VERSION = "torch-v1"
_KEYS = ("cam", "lidar", "radar", "centroid", "rz")


def make_camera() -> CameraModel:
    """Synthetic forward-facing pinhole at the reference camera scale."""
    return synthetic_camera(CAM.width, 1024, 1400.0)


def cache_path(cache_dir: str, n_frames: int, seed: int, spec: RangeViewSpec) -> str:
    """The cached dataset's file: every input that shapes the data is in
    its name (frames, seed, and a digest of the range view, the camera and
    the version tag)."""
    spec_key = hashlib.sha1((repr(spec) + repr(CAM) + _DATASET_VERSION).encode()).hexdigest()[:10]
    return os.path.join(cache_dir, f"fusion_ds_{n_frames}_{seed}_{spec_key}.npz")


def build_dataset(n_frames: int, seed: int, spec: RangeViewSpec, cache_dir: str | None = None,
                  device="cuda") -> dict[str, np.ndarray]:
    """Aligned {cam, lidar, radar, centroid, rz} arrays for n_frames scenes
    (`build_fusion_dataset`, the range view projected on `device`),
    memoized under `cache_dir` when given."""
    path = cache_path(cache_dir, n_frames, seed, spec) if cache_dir else None
    if path and os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in _KEYS}
    data = build_fusion_dataset(n_frames, seed, spec, device=device)
    data = {k: data[k] for k in _KEYS}
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(path, **data)
    return data


def evaluate(net, data, rows, device="cuda") -> dict:
    """Held-out errors of `net` (eval mode) on `rows` of `data`: mean and
    90th-percentile xy error, mean z error, mean |rz| error."""
    device = torch.device(device)
    net.to(device).eval()
    with torch.inference_mode():
        c, r = net(*(torch.from_numpy(np.ascontiguousarray(data[k][rows])).to(device)
                     for k in ("cam", "lidar", "radar")))
    c, r = c.cpu().numpy(), r.cpu().numpy()
    terr = np.linalg.norm(c[:, :2] - data["centroid"][rows, :2], axis=1)
    return {
        "xy_err": float(terr.mean()),
        "xy_err_p90": float(np.percentile(terr, 90)),
        "z_err": float(np.abs(c[:, 2] - data["centroid"][rows, 2]).mean()),
        "rz_err": float(np.abs(r[:, 0] - data["rz"][rows, 0]).mean()),
    }


def make_net() -> FusionNet:
    """The asset's architecture (bf16 FCNs, the pools above) with the
    reference constructor's distributions drawn from seed 3."""
    net = FusionNet(
        lidar_model=ModelConfig(dtype="bfloat16"),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype="bfloat16"),
        camera=CAM,
        lidar_pool=LIDAR_POOL,
        cam_pool=CAM_POOL,
    )
    init_fusion_(net, 3)
    return net


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train_frames", type=int, default=512)
    ap.add_argument("--eval_frames", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=25)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=ASSET)
    ap.add_argument("--cache_dir", default=CACHE_DIR, help="dataset cache ('' for none)")
    ap.add_argument("--variants", default="fused,lidar_only",
                    help="comma list; rerun one variant without repaying the other (results "
                         "merge into the asset json)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    refuse_reference_path(args.out, "pass --out a path outside it (the default is "
                          "tpufusion_torch/assets/fusion_net.npz)")

    spec = RangeViewSpec()
    t0 = time.time()
    train = build_dataset(args.train_frames, seed=11, spec=spec, cache_dir=args.cache_dir,
                          device=args.device)
    held = build_dataset(args.eval_frames, seed=999, spec=spec, cache_dir=args.cache_dir,
                         device=args.device)
    held_rows = np.arange(len(held["cam"]))
    print(f"datasets built ({time.time() - t0:.0f}s)", flush=True)

    results = {}
    if os.path.exists(args.out + ".json"):
        # merge over a previous run's results (e.g. rerunning one variant)
        with open(args.out + ".json") as f:
            results = json.load(f).get("results", {})
    for variant in args.variants.split(","):
        data, heldv = dict(train), dict(held)
        if variant == "lidar_only":
            # the controlled ablation: same net, data and order, camera and radar zeroed
            for d in (data, heldv):
                d["cam"] = np.zeros_like(d["cam"])
                d["radar"] = np.zeros_like(d["radar"])
        net = make_net()
        losses = train_fusion(net, data, epochs=args.epochs, batch_size=args.batch, lr=args.lr,
                              seed=5, device=args.device)
        ev = evaluate(net, heldv, held_rows, args.device)
        ev["final_loss"] = losses[-1]
        results[variant] = ev
        print(f"{variant}: {ev}", flush=True)
        if variant == "fused":
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            save_state_npz(args.out, net, dtype=np.float16)

    # context: the raw radar feature's error is the fused floor for range
    rr = held["radar"][:, 0]
    gtr = np.linalg.norm(held["centroid"][:, :2], axis=1)
    results["radar_range_noise"] = float(np.abs(rr - gtr).mean())

    with open(args.out + ".json", "w") as f:
        json.dump(
            {
                "results": results,
                "train_frames": args.train_frames,
                "eval_frames": args.eval_frames,
                "epochs": args.epochs,
                "camera": {"width": CAM.width, "height": CAM.height,
                           "scale": "full reference 512x1368"},
                "lidar_pool": list(LIDAR_POOL),
                "cam_pool": list(CAM_POOL),
            },
            f, indent=1,
        )
    print("results:", json.dumps(results, indent=1))
    print("asset ->", args.out)
    return results


if __name__ == "__main__":
    main()
