"""tpufusion_torch command-line interface (counterpart of `tpufusion/cli.py`):
the offline drive's five subcommands, extract -> train -> predict -> submit
-> score, with the reference's flags and defaults and `--device` (the card
unless "cpu" is asked for). Checkpoints are the port's
(`train/checkpoint.py`, `ckpt_<step>.pt`), not orbax. Run:

    python -m tpufusion_torch.cli <command> --help
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _cmd_train(args):
    import dataclasses
    import os

    from tpufusion_torch.config import DEFAULT, LossConfig, ModelConfig
    from tpufusion_torch.data.etl import load_camera_extracted, load_extracted
    from tpufusion_torch.data.pipeline import BatchPipeline
    from tpufusion_torch.data.registry import load_pose_csv, read_registry
    from tpufusion_torch.train.stats import population_weights
    from tpufusion_torch.train.trainer import Trainer

    camera = None
    if args.source == "camera":
        # camera-source training needs the camera model to rasterize
        # footprint labels (reference train.py:109-122 + encoder.py:270-327)
        from tpufusion_torch.geometry.camera import CameraModel

        if not args.camera_yaml:
            raise SystemExit("--camera_yaml is required with --source camera")
        camera = CameraModel().load_camera_calibration(args.camera_yaml, args.extrinsic_yaml)

    def load_dirset(ds):
        data = load_extracted(ds.dir)
        poses = load_pose_csv(os.path.join(ds.dir, "obs_poses_interp_transform.csv"))
        by_ts = {p["timestamp"]: p for p in poses}
        rows = [by_ts[int(t)] for t in data["timestamps"] if int(t) in by_ts]
        keep = [i for i, t in enumerate(data["timestamps"]) if int(t) in by_ts]
        size = np.asarray(ds.obstacle_size, np.float32)
        return {
            "images": data["images"][keep],
            "center": np.asarray([[r["tx"], r["ty"], r["tz"]] for r in rows], np.float32),
            "yaw": np.asarray([r["rz"] for r in rows], np.float32),
            "size": np.tile(size, (len(rows), 1)),
        }

    def load_camera_dirset(ds):
        from tpufusion_torch.geometry.camera import camera_label_footprint

        data = load_camera_extracted(ds.dir)
        poses = load_pose_csv(os.path.join(ds.dir, "obs_poses_camera.csv"))
        by_ts = {p["timestamp"]: p for p in poses}
        rows = [by_ts[int(t)] for t in data["timestamps"] if int(t) in by_ts]
        keep = [i for i, t in enumerate(data["timestamps"]) if int(t) in by_ts]
        imgs = data["images"][keep].astype(np.float32) / 255.0
        if imgs.ndim == 3:
            imgs = imgs[..., None]
        hw = imgs.shape[1:3]
        size = np.asarray(ds.obstacle_size, np.float32)
        labels = np.zeros((len(rows), *hw, 2), np.float32)
        for i, r in enumerate(rows):
            center = np.asarray([r["tx"], r["ty"], r["tz"]])
            labels[i], _ = camera_label_footprint(center, size, camera, hw, crop_top=args.crop_top)
        return {"images": imgs, "labels": labels}

    loader = load_camera_dirset if args.source == "camera" else load_dirset
    parts = [loader(ds) for ds in read_registry(args.train_file, args.dir_prefix)]
    train_data = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if args.source == "camera":
        # population stats from the rasterized footprints (pretrain.py:8-32)
        pos = train_data["labels"][..., 1]
        stats = {
            "positive_to_negative_ratio": float(pos.sum() / max((1.0 - pos).sum(), 1.0)),
            "average_area": float(pos.sum() / max(len(pos), 1)),
        }
    else:
        stats = population_weights(
            train_data["center"], train_data["size"], train_data["yaw"], device=args.device)
    print("population stats:", stats, file=sys.stderr)
    cfg = DEFAULT.replace(
        loss=LossConfig(
            obj_to_bkg_ratio=stats["positive_to_negative_ratio"]
            * DEFAULT.train.k_negative_sample_ratio_weight,
            avg_obj_size=stats["average_area"],
        ),
        train=dataclasses.replace(
            DEFAULT.train,
            batch_size=args.batch_size,
            epochs=args.epochs,
            learning_rate=args.lr,
            lr_schedule=args.lr_schedule,
            lr_decay_steps=args.lr_decay_steps,
        ),
    )
    in_channels = 3
    if args.source == "camera":
        # camera labels are precomputed classification footprints; the
        # regression head (either family) is off, so --head is ignored
        cfg = cfg.replace(model=ModelConfig(vertical_stride=2, use_regression=False))
        in_channels = 1
    elif args.head != "corner":
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, head=args.head, reg_output_activation="linear"),
            train=dataclasses.replace(cfg.train, augment=False),
        )
    trainer = Trainer(cfg, outdir=args.outdir, in_channels=in_channels, device=args.device)
    if args.resume:
        trainer.resume()
    val_pipe = None
    if args.val_file:
        vparts = [loader(ds) for ds in read_registry(args.val_file, args.dir_prefix)]
        val_data = {k: np.concatenate([p[k] for p in vparts]) for k in vparts[0]}
        val_pipe = BatchPipeline(val_data, cfg.train.batch_size, shuffle=False, device=args.device)
    trainer.fit(
        BatchPipeline(train_data, cfg.train.batch_size, seed=cfg.train.seed, device=args.device),
        val_pipe,
    )


def _cmd_predict(args):
    import dataclasses

    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.predict import predict_dataset_dir
    from tpufusion_torch.train.checkpoint import CheckpointManager

    cfg = DEFAULT
    if args.head != "corner":
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, head=args.head, reg_output_activation="linear"))
    model = FCN(cfg.model, in_channels=3, seed=0)
    if args.checkpoint:
        CheckpointManager(args.checkpoint).restore(model, device=args.device)
    report = predict_dataset_dir(
        model, args.dataset, args.output_dir, cfg, batch=args.batch_size, device=args.device)
    print(json.dumps(report))


def _cmd_submit(args):
    from tpufusion_torch.eval.submission import generate_submission

    meta = {"l": args.l, "w": args.w, "h": args.h}
    offset = tuple(args.offset) if args.offset else None
    generate_submission(args.predictions, args.camera_timestamps, meta, args.output, offset)
    print(json.dumps({"output": args.output}))


def _cmd_score(args):
    import csv as _csv

    from tpufusion_torch.eval.scoring import score_poses

    def read_poses(path):
        # prediction CSVs carry l/w/h; ground-truth pose CSVs may not —
        # fall back to the metadata size flags there
        rows = []
        with open(path) as f:
            for r in _csv.DictReader(f):
                rows.append([
                    float(r["tx"]), float(r["ty"]), float(r["tz"]),
                    float(r.get("rz", 0.0)),
                    float(r.get("l") or args.l), float(r.get("w") or args.w),
                    float(r.get("h") or args.h),
                ])
        return np.asarray(rows)

    print(json.dumps(score_poses(
        read_poses(args.predictions), read_poses(args.truth), pose_frame=args.pose_frame)))


def _cmd_extract(args):
    if args.input.endswith(".bag"):
        from tpufusion_torch.data.etl import extract_bag_dataset

        report = extract_bag_dataset(
            args.input,
            args.output_dir,
            tracklet_xml=args.tracklet,
            camera_yaml=args.camera_yaml,
            extrinsic_yaml=args.extrinsic_yaml,
            crop=(args.crop_top, args.crop_bottom),
            save_png=args.png,
            streaming=args.streaming,
            device=args.device,
        )
    else:
        from tpufusion_torch.data.etl import extract_dataset

        npz = np.load(args.input)
        report = extract_dataset(
            args.output_dir,
            npz["points"],
            npz["timestamps"],
            tracklet_xml=args.tracklet,
            camera_timestamps=npz.get("camera_timestamps"),
            device=args.device,
        )
    print(json.dumps(report))


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device the tensors run on (default: the card; "
                        "'cpu' runs the plain versions of the kernels)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpufusion_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train the lidar or camera FCN")
    t.add_argument("--train_file", required=True)
    t.add_argument("--val_file", default=None)
    t.add_argument("--dir_prefix", default="")
    t.add_argument("--outdir", default="./runs/lidar")
    t.add_argument("--batch_size", type=int, default=64)
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--lr_schedule", choices=("constant", "cosine"), default="constant",
                   help="constant matches the reference (model.py:186)")
    t.add_argument("--lr_decay_steps", type=int, default=0,
                   help="cosine horizon in optimizer steps (0 = heuristic)")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--source", choices=("lidar", "camera"), default="lidar",
                   help="training data source (train.py:109-122)")
    t.add_argument("--head", choices=("corner", "direct"), default="corner",
                   help="regression head family: corner = reference parity "
                        "(encoder.py:156-238); direct = the framework's "
                        "8-channel pose head (linear output, no roll aug)")
    t.add_argument("--camera_yaml", default=None,
                   help="camera intrinsics YAML (camera source)")
    t.add_argument("--extrinsic_yaml", default=None,
                   help="lidar->camera extrinsics YAML (camera source)")
    t.add_argument("--crop_top", type=int, default=430,
                   help="camera crop offset used at extraction")
    _add_device(t)
    t.set_defaults(fn=_cmd_train)

    pr = sub.add_parser("predict", help="batch inference -> pose CSV")
    pr.add_argument("dataset")
    pr.add_argument("--checkpoint", default=None,
                    help="a checkpoint directory of `train` (<outdir>/ckpt)")
    pr.add_argument("--output_dir", default="./predictions")
    pr.add_argument("--batch_size", type=int, default=32)
    pr.add_argument("--head", choices=("corner", "direct"), default="corner",
                    help="must match the head the checkpoint was trained with")
    _add_device(pr)
    pr.set_defaults(fn=_cmd_predict)

    sb = sub.add_parser("submit", help="pose CSV -> tracklet XML")
    sb.add_argument("predictions")
    sb.add_argument("camera_timestamps")
    sb.add_argument("output")
    sb.add_argument("--l", type=float, required=True)
    sb.add_argument("--w", type=float, required=True)
    sb.add_argument("--h", type=float, required=True)
    sb.add_argument("--offset", type=float, nargs=3, default=None)
    sb.set_defaults(fn=_cmd_submit)

    sc = sub.add_parser("score", help="pose CSV vs truth CSV -> metrics")
    sc.add_argument("predictions")
    sc.add_argument("truth")
    sc.add_argument("--l", type=float, default=0.0,
                    help="obstacle size fallback when the CSV lacks l/w/h")
    sc.add_argument("--w", type=float, default=0.0)
    sc.add_argument("--h", type=float, default=0.0)
    sc.add_argument("--pose_frame", choices=("orbit", "physical"), default="orbit",
                    help="coordinate convention of BOTH CSVs: the predict "
                         "pipeline and the GT interp CSVs are orbit-origin "
                         "(center pre-rotation by rz); metrics are always "
                         "physical-frame (see eval/scoring docstring)")
    sc.set_defaults(fn=_cmd_score)

    ex = sub.add_parser("extract", help=".bag or points NPZ -> dataset dir")
    ex.add_argument("input")
    ex.add_argument("output_dir")
    ex.add_argument("--tracklet", default=None)
    ex.add_argument("--camera_yaml", default=None,
                    help="camera intrinsics YAML (enables rectification)")
    ex.add_argument("--extrinsic_yaml", default=None,
                    help="lidar->camera extrinsics YAML")
    ex.add_argument("--crop_top", type=int, default=430)
    ex.add_argument("--crop_bottom", type=int, default=942)
    ex.add_argument("--streaming", default=None, action=argparse.BooleanOptionalAction,
                    help="two-pass memmap extraction (bounded host "
                         "memory; default: auto by bag size)")
    ex.add_argument("--png", action="store_true",
                    help="also save per-frame camera PNGs")
    _add_device(ex)
    ex.set_defaults(fn=_cmd_extract)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
