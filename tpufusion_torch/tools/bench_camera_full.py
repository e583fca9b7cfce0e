"""Time and convergence-check camera-FCN training at the full reference
scale (counterpart of `tpufusion/tools/bench_camera_full.py`).

The reference trains its camera variant on 512 x 1368 x 1 crops with the
lidar FCN's geometry at vertical stride 2 and no regression head. This
tool measures that shape:

  * ms a train step (`train.train_step.make_train_step`, bf16, batch 8 by
    default) over distinct batches, between CUDA events
    (`benchmarks.measure`, which also reports the step's device time and
    busy share), and on the card the five longest device kernels of a
    step with their shares of its device time;
  * a short convergence run on a fixed synthetic camera dataset (labels
    from `geometry.camera.camera_label_footprint`, the encoder the CLI
    uses), its batches gathered from tensors staged on the device once:
    the loss, precision and recall trajectory.

    python -m tpufusion_torch.tools.bench_camera_full [--batch 8] [--steps 120] [--device cuda]

Prints one JSON line. On the CPU (`--device cpu`, small sizes) the times
are the host clock's.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tpufusion_torch.benchmarks import measure
from tpufusion_torch.config import LossConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.data.synthetic import render_camera_frames
from tpufusion_torch.geometry.camera import camera_label_footprint
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.tools.train_fusion_synthetic import CAM, make_camera
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.train_step import make_train_step

CAMERA_MODEL = ModelConfig(vertical_stride=2, use_regression=False, dtype="bfloat16")


def build_camera_dataset(n_frames: int, seed: int):
    """(frames (F, 512, 1368, 1), labels (F, 512, 1368, 2)) synthetic
    scenes, numpy only: vehicle centers inside the camera's field of view,
    frames rendered like the fusion tool's camera branch, labels through
    the reference's outer-rect footprint encoder. The same seed gives the
    reference tool's bits."""
    rng = np.random.default_rng(seed)
    cam = make_camera()
    n = n_frames
    dist = rng.uniform(8.0, 30.0, n)
    ang = rng.uniform(-0.35, 0.35, n)
    phys = np.stack(
        [dist * np.cos(ang), dist * np.sin(ang), rng.uniform(-1.0, -0.4, n)], axis=-1,
    ).astype(np.float32)
    size = np.broadcast_to(np.array([4.2, 1.6, 1.5], np.float32), (n, 3)).copy()
    frames = render_camera_frames(phys, size, cam, rng)
    # the pinhole renders the full 1024-row frame and render_camera_frames
    # center-crops it to 512: the label projection takes the same v-shift
    vcrop = (1024 - CAM.height) // 2
    labels = np.empty((n, CAM.height, CAM.width, 2), np.float32)
    for i in range(n):
        labels[i], _ = camera_label_footprint(phys[i], size[i], cam, (CAM.height, CAM.width),
                                              crop_top=vcrop)
    return frames, labels


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--timing_batches", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    frames, labels = build_camera_dataset(args.frames, seed=31)
    pos = labels[..., 1]
    loss_cfg = LossConfig(
        obj_to_bkg_ratio=float(pos.sum() / max((1.0 - pos).sum(), 1.0)),
        avg_obj_size=float(pos.sum() / max(len(pos), 1)),
    )
    step = make_train_step(
        RangeViewSpec(),  # unused: the batches carry their images
        loss_cfg, TrainConfig(batch_size=args.batch, augment=False),
        use_regression=False, device=device,
    )
    frames_d = torch.from_numpy(frames).to(device)
    labels_d = torch.from_numpy(labels).to(device)

    # timing: distinct fixed batches
    b = args.batch
    model = FCN(CAMERA_MODEL, in_channels=1, seed=0).to(device)
    opt = Adam(model.parameters(), args.lr)
    sets = []
    for i in range(args.timing_batches):
        rows = torch.from_numpy(np.arange(i * b, (i + 1) * b) % len(frames)).to(device)
        sets.append(({"images": frames_d[rows], "labels": labels_d[rows]},))
    dt, how = measure(lambda batch: step(model, opt, batch)[0], sets, reps=3, device=device)
    out = {
        "metric": "camera-FCN train step, full 512x1368 reference shape",
        "ms_per_step": round(dt * 1e3, 3),
        "batch": b,
        "frames_per_sec": round(b / dt, 1),
        **how,
    }
    if device.type == "cuda":
        from tpufusion_torch.kernel_bench import top_device_kernels

        out["top_kernels"] = [
            {"name": k["name"], "ms": round(k["ms"], 4), "share": round(k["share"], 4)}
            for k in top_device_kernels(lambda a: step(model, opt, *a), sets)]
    print(f"train step {out['ms_per_step']} ms at batch {b} ({how['timer']})", flush=True)

    # convergence: a fresh model and optimizer on the staged dataset
    model = FCN(CAMERA_MODEL, in_channels=1, seed=0).to(device)
    opt = Adam(model.parameters(), args.lr)
    hist = []
    rng = np.random.default_rng(5)
    for s in range(args.steps):
        rows = torch.from_numpy(rng.choice(len(frames), b, replace=False)).to(device)
        _, metrics = step(model, opt, {"images": frames_d[rows], "labels": labels_d[rows]})
        if s % 20 == 0 or s == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            hist.append({"step": s, "loss": round(m["loss"], 4),
                         "precision": round(m["precision"], 3), "recall": round(m["recall"], 3)})
            print(hist[-1], flush=True)

    out.update({
        "loss_first": hist[0]["loss"],
        "loss_last": hist[-1]["loss"],
        "recall_last": hist[-1]["recall"],
        "precision_last": hist[-1]["precision"],
        "steps": args.steps,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    })
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
