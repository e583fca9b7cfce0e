"""Full-geometry bag -> submission rehearsal, timed (counterpart of
`tpufusion/tools/rehearse_bag_pipeline.py`).

The reference's production flow was hand-run stages on a recorded drive:
extract the bag (range tensors + GT CSVs), train, predict, write the
submission XML. This tool rehearses it at the real geometry: a
BagWriter-synthesized multi-topic bag (velodyne PointCloud2 + camera
Image + radar tracks + a GT tracklet XML) pushed through the port's CLI,
extract -> train -> predict -> submit -> score, at the full 32 x 1801
range view on `--device`, with each stage's wall time and the host's
memory (sampled every 10 ms: the stage's peak and what the process held
when it began, of the whole resident set and of its unshared part, which
leaves out file pages such as the streaming extractor's memmaps). A first
stage, `setup`, builds the native codec and the kernels and starts the
device, so that no other stage's time includes a build.

    python -m tpufusion_torch.tools.rehearse_bag_pipeline [--device cuda]
        [--frames 64] [--streaming] [--workdir DIR]

Prints one JSON line a stage on stderr, then a summary line on stdout.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import threading
import time
from contextlib import redirect_stdout


def synthesize_bag(path: str, frames: int, n_points: int, seed: int,
                   cam_hw: tuple[int, int] = (1096, 1368)) -> dict:
    """Write a rosbag-v2 bag with the challenge's three sensor topics and
    return the GT arrays. Clouds are beam-structured ray-cast scans at
    the full sweep resolution, drawn with numpy from `seed` (the
    reference draws the same distribution from jax.random: other bits);
    camera frames are synthetic uint8 ramps at the reference's raw
    capture height (rows 430:942 survive the crop); radar tracks carry
    the GT range / angle so the extracted radar CSV has physical content."""
    import numpy as np

    from tpufusion_torch.data.rosbag_reader import (
        RADAR_TRACKS_DEFINITION,
        BagWriter,
        serialize_image,
        serialize_pointcloud2,
        serialize_radar_tracks,
    )
    from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
    from tpufusion_torch.eval.tracklet_xml import Tracklet, TrackletCollection

    pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(seed), frames, n_points)
    center, size, yaw = gt["center"], gt["size"], gt["yaw"]

    w = BagWriter(compression="lz4")
    w.add_connection(0, "/velodyne_points", "sensor_msgs/PointCloud2")
    w.add_connection(1, "/image_raw", "sensor_msgs/Image")
    w.add_connection(2, "/radar/tracks", "radar_driver/RadarTracks", RADAR_TRACKS_DEFINITION)
    t0 = 1_490_000_000_000_000_000
    dt = 100_000_000  # 10 Hz capture, like the challenge bags
    h, wd = cam_hw
    ramp = np.arange(h, dtype=np.uint32)[:, None] + np.arange(wd, dtype=np.uint32)[None, :]
    cloud_bytes = 0
    for i in range(frames):
        cloud = pts[i][valid[i]]  # variable-size clouds, like real scans
        raw = serialize_pointcloud2(cloud.astype(np.float32))
        cloud_bytes += len(raw)
        w.add_message(0, t0 + i * dt, raw)
        img = ((ramp + 7 * i) % 256).astype(np.uint8)
        w.add_message(1, t0 + i * dt + 3_000_000, serialize_image(img, encoding="mono8"))
        rng = float(np.hypot(center[i, 0], center[i, 1]))
        ang = float(np.degrees(np.arctan2(center[i, 1], center[i, 0])))
        w.add_message(2, t0 + i * dt + 5_000_000, serialize_radar_tracks(
            [{"number": 1, "range": rng, "angle": ang, "rate": 0.0,
              "width": float(size[i, 1]), "late_rate": 0.0}]
        ))
    w.write(path)

    t = Tracklet("Car", l=float(size[0, 0]), w=float(size[0, 1]), h=float(size[0, 2]))
    for i in range(frames):
        t.poses.append({
            "tx": float(center[i, 0]), "ty": float(center[i, 1]),
            "tz": float(center[i, 2]), "rx": 0.0, "ry": 0.0, "rz": float(yaw[i]),
        })
    gt_xml = os.path.splitext(path)[0] + "_gt.xml"
    TrackletCollection([t]).write_xml(gt_xml)
    return {
        "gt_xml": gt_xml,
        "timestamps": [t0 + i * dt for i in range(frames)],
        "bag_bytes": os.path.getsize(path),
        "cloud_bytes": cloud_bytes,
        "mean_size": size.mean(axis=0).tolist(),
    }


def _rss_mib() -> dict[str, float]:
    """This process's resident set now and the part of it not shared with
    files (resident minus shared pages, Linux /proc/self/statm), in MiB."""
    with open("/proc/self/statm") as f:
        _, resident, shared = (int(v) for v in f.read().split()[:3])
    page = os.sysconf("SC_PAGE_SIZE") / 2**20
    return {"rss": resident * page, "unshared": (resident - shared) * page}


class _PeakRss:
    """The largest resident set (and unshared part) seen while the block
    runs, sampled every 10 ms by a thread, and what it began with."""

    def __enter__(self):
        self.start = _rss_mib()
        self.peak = dict(self.start)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _take(self):
        for k, v in _rss_mib().items():
            self.peak[k] = max(self.peak[k], v)

    def _sample(self):
        while not self._stop.wait(0.01):
            self._take()

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._take()

    def report(self) -> dict[str, float]:
        return {f"{k}_{when}_mib": d[k] for k in self.start
                for when, d in (("start", self.start), ("peak", self.peak))}


def _setup(device: str) -> None:
    """Builds the native codec and, for a CUDA device, the kernels, and
    starts the device."""
    import torch

    from tpufusion_torch import _build, native

    native.load()
    if torch.device(device).type == "cuda":
        _build.load()
        torch.empty(0, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--head", default="direct", choices=("direct", "corner"))
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "rehearse_bag"))
    ap.add_argument("--streaming", action="store_true",
                    help="extract in two streaming passes (memmapped .npy outputs)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpufusion_torch.cli import main as cli_main

    os.makedirs(args.workdir, exist_ok=True)
    bag = os.path.join(args.workdir, "scene.bag")
    ds = os.path.join(args.workdir, "ds")
    run = os.path.join(args.workdir, "run")
    pred = os.path.join(args.workdir, "pred")
    dev = ["--device", args.device]
    timings: dict[str, float] = {}
    rss: dict[str, dict[str, float]] = {}

    def stage(name, fn):
        t = time.perf_counter()
        with _PeakRss() as mem:
            out = fn()
        timings[name] = time.perf_counter() - t
        rss[name] = mem.report()
        print(json.dumps({"stage": name, "s": timings[name], "rss": rss[name]}),
              file=sys.stderr)
        return out

    stage("setup", lambda: _setup(args.device))
    meta = stage("synthesize_bag", lambda: synthesize_bag(
        bag, args.frames, args.n_points, args.seed))

    stream = ["--streaming"] if args.streaming else []
    stage("extract", lambda: cli_main(
        ["extract", bag, ds, "--tracklet", meta["gt_xml"], *stream, *dev]))

    # registry row pointing at the extracted dir (the reference's
    # train.py consumed the same per-bag dataset-dir layout)
    reg = os.path.join(args.workdir, "registry.csv")
    mcsv = os.path.join(args.workdir, "meta.csv")
    with open(reg, "w") as f:
        f.write("ds,meta.csv\n")
    ms = meta["mean_size"]
    with open(mcsv, "w") as f:
        f.write(f"l,w,h\n{ms[0]:.3f},{ms[1]:.3f},{ms[2]:.3f}\n")

    stage("train", lambda: cli_main(
        ["train", "--train_file", reg, "--dir_prefix", args.workdir,
         "--outdir", run, "--batch_size", str(args.batch),
         "--epochs", str(args.epochs), "--head", args.head, *dev]))

    stage("predict", lambda: cli_main(
        ["predict", ds, "--checkpoint", os.path.join(run, "ckpt"),
         "--output_dir", pred, "--batch_size", str(args.batch),
         "--head", args.head, *dev]))

    pred_csv = os.path.join(pred, "objects_obs1_lidar_predictions.csv")
    sub_xml = os.path.join(args.workdir, "submission.xml")
    size_flags = ["--l", f"{ms[0]:.3f}", "--w", f"{ms[1]:.3f}", "--h", f"{ms[2]:.3f}"]
    stage("submit", lambda: cli_main(
        ["submit", pred_csv, os.path.join(ds, "camera_timestamps.csv"), sub_xml,
         *size_flags]))

    buf = io.StringIO()

    def _score():
        with redirect_stdout(buf):
            cli_main(["score", pred_csv,
                      os.path.join(ds, "obs_poses_interp_transform.csv"), *size_flags])

    stage("score", _score)
    score = json.loads(buf.getvalue().splitlines()[-1])

    from tpufusion_torch.eval.tracklet_xml import parse_tracklet_xml

    n_sub = len(parse_tracklet_xml(sub_xml)[0].poses)
    summary = {
        "frames": args.frames,
        "n_points": args.n_points,
        "bag_mb": meta["bag_bytes"] / 1e6,
        "head": args.head,
        "epochs": args.epochs,
        "streaming": args.streaming,
        "device": args.device,
        "timings_s": timings,
        "total_s": sum(timings.values()),
        "extract_frames_per_s": args.frames / timings["extract"],
        "rss_mib": rss,
        "submission_poses": n_sub,
        "score": score,
        "workdir": args.workdir,
    }
    print(json.dumps(summary))
    if n_sub != args.frames:
        raise RuntimeError(f"the submission holds {n_sub} poses for {args.frames} frames")
    return summary


if __name__ == "__main__":
    main()
