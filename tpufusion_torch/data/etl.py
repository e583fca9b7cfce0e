"""Offline extraction (ETL): raw frames -> training-ready dataset dirs
(counterpart of `tpufusion/data/etl.py`).

Rebuilds the reference ETL driver (`modules/lidar/process/extract_rosbag.py`)
without ROS: the input is per-frame point-cloud arrays (from any upstream
reader — NPZ dumps, a rosbag converted offline, a Waymo segment), and the
outputs are the same logical artifacts the reference wrote per bag
(`extract_rosbag.py:52-60,314-347`):

    lidar_frames.npz                 range-view tensors (device-projected,
                                     batched — the per-frame NumPy loops of
                                     extract_rosbag_lidar.py are gone)
    bev_frames.npz                   BEV rasters (optional)
    lidar_timestamps.csv / camera_timestamps.csv
    radar/radar_tracks.csv
    obs_poses_interp_transform.csv   GT interpolated onto lidar timestamps
    obs_poses_camera.csv             GT interpolated onto camera timestamps

plus the per-topic max-gap report (`extract_rosbag.py:302-307`). Duplicate
timestamps are dropped like the reference's dedup (`:316-321`).

The range view (and the BEV, when asked for) of each batch is computed on
`device`, the card unless the caller asks for "cpu", through the port's
`range_view_project_batch` (the z-buffer kernel) and
`bev_rasterize_batch`; everything else is host code. The streaming path
projects each batch as it comes, without padding it to a fixed batch
size (the reference pads so that XLA compiles once); its output is the
same.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from tpufusion_torch.config import BevSpec, RangeViewSpec
from tpufusion_torch.eval.interpolate import interpolate_poses
from tpufusion_torch.eval.tracklet_xml import flatten_tracklets, parse_tracklet_xml
from tpufusion_torch.geometry.bev import bev_rasterize_batch
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.utils.logging import get_logger

log = get_logger("etl")


def _dedup(timestamps: np.ndarray) -> np.ndarray:
    """Indices of first occurrences, order preserved."""
    _, idx = np.unique(np.asarray(timestamps, np.int64), return_index=True)
    return np.sort(idx)


@torch.inference_mode()
def _project(points: np.ndarray, spec: RangeViewSpec, bev: BevSpec | None, device):
    """One batch of padded clouds (B, N, 4), NaN padding allowed -> (range
    view (B, H, W, 3), BEV (B, nx, ny, C) or None) as numpy, computed on
    `device`."""
    chunk = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(device)
    images = range_view_project_batch(chunk, spec).cpu().numpy()
    if bev is None:
        return images, None
    return images, bev_rasterize_batch(chunk, bev).cpu().numpy()


def _write_ts_csv(path: str, timestamps) -> None:
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["timestamp"])
        for t in timestamps:
            wr.writerow([int(t)])


def _read_ts_csv(path: str) -> np.ndarray:
    with open(path, newline="") as f:
        rd = csv.reader(f)
        next(rd)  # header
        return np.asarray([int(r[0]) for r in rd], np.int64)


def _write_pose_csv(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(
            f, ["timestamp", "tx", "ty", "tz", "rx", "ry", "rz"]
        )
        wr.writeheader()
        for r in rows:
            wr.writerow({k: r[k] for k in wr.fieldnames})


def max_gap_report(streams: dict[str, np.ndarray]) -> dict[str, float]:
    """Per-stream max inter-message gap in seconds (`extract_rosbag.py:
    302-307`)."""
    out = {}
    for name, ts in streams.items():
        ts = np.sort(np.asarray(ts, np.int64))
        out[name] = float(np.diff(ts).max() / 1e9) if len(ts) > 1 else 0.0
    return out


def process_camera_frame(
    img: np.ndarray,
    encoding: str = "mono8",
    camera=None,  # CameraModel with loaded calibration, or None
    crop: tuple[int, int] = (430, 942),
) -> np.ndarray:
    """One camera frame -> training-ready grayscale: rectify (when a
    camera model is given), then crop rows — the reference's `save_image`
    order (`extract_rosbag.py:71-76`, crop rows 430:942 per
    `process/globals.py:15-16`) plus the grayscale conversion its loader
    did at training time (`train/loader.py:211-231`)."""
    img = np.asarray(img)
    if camera is not None:
        img = camera.rectify_image(img)
    img = img[crop[0] : crop[1]]
    if img.ndim == 3 and img.shape[2] >= 3:
        # ITU-R 601 luma, matching cv2 grayscale conversion
        order = (2, 1, 0) if encoding.startswith("bgr") else (0, 1, 2)
        r, g, b = (img[..., i].astype(np.float32) for i in order)
        img = (0.299 * r + 0.587 * g + 0.114 * b).round().astype(np.uint8)
    elif img.ndim == 3:
        img = img[..., 0]
    return img


def extract_dataset(
    out_dir: str,
    lidar_points: np.ndarray,  # (F, N, 4) padded clouds (NaN padding ok)
    lidar_timestamps: np.ndarray,  # (F,) ns
    tracklet_xml: str | None = None,  # ground-truth tracklet file
    camera_timestamps: np.ndarray | None = None,
    radar_rows: list[dict] | None = None,
    camera_frames: np.ndarray | None = None,  # (Fc, H, W) uint8 processed
    spec: RangeViewSpec = RangeViewSpec(),
    bev: BevSpec | None = None,
    batch: int = 32,
    save_png: bool = False,
    device: torch.device | str = "cuda",
) -> dict:
    """Padded clouds -> a dataset dir (the .npz layout); the tensors are
    projected on `device` (the card unless the caller asks for "cpu";
    without a card that raises)."""
    os.makedirs(out_dir, exist_ok=True)

    keep = _dedup(lidar_timestamps)
    if len(keep) != len(lidar_timestamps):
        log.info("dropped %d duplicate lidar timestamps",
                 len(lidar_timestamps) - len(keep))
    lidar_points = lidar_points[keep]
    lidar_timestamps = np.asarray(lidar_timestamps, np.int64)[keep]

    # device-projected tensors, in batches
    frames, bevs = [], []
    for lo in range(0, len(lidar_points), batch):
        images, bev_images = _project(lidar_points[lo : lo + batch], spec, bev, device)
        frames.append(images)
        if bev is not None:
            bevs.append(bev_images)
    images = np.concatenate(frames) if frames else np.zeros((0,))
    np.savez_compressed(
        os.path.join(out_dir, "lidar_frames.npz"),
        images=images,
        timestamps=lidar_timestamps,
    )
    if bev is not None:
        np.savez_compressed(
            os.path.join(out_dir, "bev_frames.npz"),
            images=np.concatenate(bevs),
            timestamps=lidar_timestamps,
        )

    if camera_timestamps is not None:
        camera_timestamps = np.asarray(camera_timestamps, np.int64)
        cam_keep = _dedup(camera_timestamps)
        camera_timestamps = camera_timestamps[cam_keep]
        if camera_frames is not None:
            camera_frames = np.asarray(camera_frames)[cam_keep]
            np.savez_compressed(
                os.path.join(out_dir, "camera_frames.npz"),
                images=camera_frames,
                timestamps=camera_timestamps,
            )
            if save_png:
                # per-frame PNGs in the reference's camera/ layout
                # (`extract_rosbag.py:73-76`)
                from PIL import Image as PILImage

                png_dir = os.path.join(out_dir, "camera")
                os.makedirs(png_dir, exist_ok=True)
                for ts, frame in zip(camera_timestamps, camera_frames):
                    PILImage.fromarray(frame).save(
                        os.path.join(png_dir, f"{int(ts)}_image.png")
                    )

    return _write_metadata(
        out_dir, lidar_timestamps, camera_timestamps, radar_rows,
        tracklet_xml,
    )


def _write_metadata(
    out_dir: str,
    lidar_timestamps: np.ndarray,
    camera_timestamps: np.ndarray | None,
    radar_rows: list[dict] | None,
    tracklet_xml: str | None,
) -> dict:
    """Non-tensor dataset artifacts, shared by the in-RAM and streaming
    extractors: timestamp CSVs, radar CSV, interpolated tracklet GT, and
    the max-gap report (timestamps must already be deduped)."""
    _write_ts_csv(
        os.path.join(out_dir, "lidar_timestamps.csv"), lidar_timestamps
    )
    if camera_timestamps is not None:
        _write_ts_csv(
            os.path.join(out_dir, "camera_timestamps.csv"), camera_timestamps
        )

    if radar_rows:
        os.makedirs(os.path.join(out_dir, "radar"), exist_ok=True)
        with open(
            os.path.join(out_dir, "radar", "radar_tracks.csv"), "w", newline=""
        ) as f:
            wr = csv.DictWriter(f, list(radar_rows[0].keys()))
            wr.writeheader()
            wr.writerows(radar_rows)

    gt = {}
    if tracklet_xml is not None and camera_timestamps is None:
        # tracklet pose rows are camera-frame-indexed (the reference joins
        # frame id -> timestamp through the /image_raw stream,
        # tracket_parser.py:73-93) — without a camera stream the join is
        # undefined. Say so instead of silently dropping the user's GT.
        log.warning(
            "--tracklet %s ignored: no camera timestamps in this source "
            "(tracklet frame indices are camera-frame-indexed)",
            tracklet_xml,
        )
    if tracklet_xml is not None and camera_timestamps is not None:
        tracklets = parse_tracklet_xml(tracklet_xml)
        source = flatten_tracklets(tracklets, list(map(int, camera_timestamps)))
        source = [r for r in source if "timestamp" in r]
        lidar_gt = interpolate_poses(source, list(map(int, lidar_timestamps)))
        cam_gt = interpolate_poses(source, list(map(int, camera_timestamps)))
        _write_pose_csv(
            os.path.join(out_dir, "obs_poses_interp_transform.csv"), lidar_gt
        )
        _write_pose_csv(os.path.join(out_dir, "obs_poses_camera.csv"), cam_gt)
        gt = {"lidar_gt": len(lidar_gt), "camera_gt": len(cam_gt)}

    streams = {"lidar": lidar_timestamps}
    if camera_timestamps is not None:
        streams["camera"] = camera_timestamps
    report = {"frames": int(len(lidar_timestamps)), "max_gap_s": max_gap_report(streams)}
    report.update(gt)
    log.info("extracted %s: %s", out_dir, report)
    return report


def load_extracted(out_dir: str) -> dict[str, np.ndarray]:
    npy = os.path.join(out_dir, "lidar_frames.npy")
    if os.path.exists(npy):
        # streaming-extracted dataset: memmapped tensors + CSV timestamps
        return {
            "images": np.load(npy, mmap_mode="r"),
            "timestamps": _read_ts_csv(
                os.path.join(out_dir, "lidar_timestamps.csv")
            ),
        }
    data = np.load(os.path.join(out_dir, "lidar_frames.npz"))
    return {"images": data["images"], "timestamps": data["timestamps"]}


def load_camera_extracted(out_dir: str) -> dict[str, np.ndarray]:
    npy = os.path.join(out_dir, "camera_frames.npy")
    if os.path.exists(npy):
        return {
            "images": np.load(npy, mmap_mode="r"),
            "timestamps": _read_ts_csv(
                os.path.join(out_dir, "camera_timestamps.csv")
            ),
        }
    data = np.load(os.path.join(out_dir, "camera_frames.npz"))
    return {"images": data["images"], "timestamps": data["timestamps"]}


def extract_bag_dataset(
    bag_path: str,
    out_dir: str,
    tracklet_xml: str | None = None,
    camera_yaml: str | None = None,
    extrinsic_yaml: str | None = None,
    crop: tuple[int, int] = (430, 942),
    lidar_topic: str = "/velodyne_points",
    image_topic: str = "/image_raw",
    radar_topic: str = "/radar/tracks",
    spec: RangeViewSpec = RangeViewSpec(),
    bev: BevSpec | None = None,
    save_png: bool = False,
    streaming: bool | None = None,
    batch: int = 32,
    device: torch.device | str = "cuda",
) -> dict:
    """One command: `.bag` -> full dataset dir, the counterpart of the
    reference's `extract_rosbag.py main` (`:234-314`): lidar clouds ->
    range-view tensors, `/image_raw` -> rectified+cropped camera frames
    (`handle_msg:141-160`), `/radar/tracks` -> CSV rows (`:136-139`),
    timestamp CSVs, and tracklet ground truth interpolated onto both
    streams.

    streaming=None picks automatically: bags whose padded cloud tensor
    would exceed ~1 GB are extracted in two streaming passes with the
    output tensors written through disk memmaps (lidar_frames.npy /
    camera_frames.npy instead of the .npz pair) — peak host memory is one
    projection batch, so 10-20 GB challenge bags extract on small hosts.
    load_extracted/load_camera_extracted read either layout (the .npy
    memmap-backed). The tensors are projected on `device` (the card
    unless the caller asks for "cpu"; without a card that raises)."""
    from tpufusion_torch.data.rosbag_reader import (
        BagReader,
        parse_image,
        parse_pointcloud2,
        parse_radar_tracks,
        pointcloud2_size,
    )

    camera = None
    if camera_yaml is not None:
        from tpufusion_torch.geometry.camera import CameraModel

        camera = CameraModel().load_camera_calibration(
            camera_yaml, extrinsic_yaml
        )

    def is_lidar(msg):
        return (msg.topic == lidar_topic
                or msg.msg_type == "sensor_msgs/PointCloud2")

    def is_camera(msg):
        return (msg.topic == image_topic
                or msg.msg_type == "sensor_msgs/Image")

    # ---- pass 1: timestamps, cloud sizes (header peeks), radar rows ----
    reader = BagReader(bag_path)
    lidar_ts: list[int] = []
    lidar_n: list[int] = []
    cam_ts: list[int] = []
    cam_shape: tuple | None = None
    radar_rows: list[dict] = []
    for msg in reader.read_messages():
        if is_lidar(msg):
            lidar_ts.append(msg.timestamp)
            lidar_n.append(pointcloud2_size(msg.raw))
        elif is_camera(msg):
            if cam_shape is None:
                img, encoding = parse_image(msg.raw)
                cam_shape = process_camera_frame(
                    img, encoding, camera, crop
                ).shape
            cam_ts.append(msg.timestamp)
        elif msg.topic == radar_topic:
            radar_rows.extend(parse_radar_tracks(msg))

    if not lidar_ts:
        raise ValueError(f"no {lidar_topic!r} messages in {bag_path}")
    nmax = max(lidar_n)
    if streaming is None:
        streaming = len(lidar_ts) * nmax * 16 > (1 << 30)

    if not streaming:
        # in-RAM path (golden .npz layout): re-stream collecting payloads
        clouds: list[np.ndarray] = []
        cam_frames: list[np.ndarray] = []
        for msg in BagReader(bag_path).read_messages():
            if is_lidar(msg):
                clouds.append(parse_pointcloud2(msg.raw))
            elif is_camera(msg):
                img, encoding = parse_image(msg.raw)
                cam_frames.append(
                    process_camera_frame(img, encoding, camera, crop)
                )
        points = np.full((len(clouds), nmax, 4), np.nan, np.float32)
        for i, c in enumerate(clouds):
            points[i, : len(c)] = c
        return extract_dataset(
            out_dir,
            points,
            np.asarray(lidar_ts, np.int64),
            tracklet_xml=tracklet_xml,
            camera_timestamps=(
                np.asarray(cam_ts, np.int64) if cam_ts else None
            ),
            radar_rows=radar_rows,
            camera_frames=np.stack(cam_frames) if cam_frames else None,
            spec=spec,
            bev=bev,
            batch=batch,
            save_png=save_png,
            device=device,
        )

    # ---- streaming path: memmap outputs, one projection batch in RAM ---
    os.makedirs(out_dir, exist_ok=True)
    lidar_ts = np.asarray(lidar_ts, np.int64)
    lidar_keep = np.zeros(len(lidar_ts), bool)
    lidar_keep[_dedup(lidar_ts)] = True
    if int(lidar_keep.sum()) != len(lidar_ts):
        log.info("dropped %d duplicate lidar timestamps",
                 len(lidar_ts) - int(lidar_keep.sum()))
    cam_ts_arr = np.asarray(cam_ts, np.int64)
    cam_keep = np.zeros(len(cam_ts_arr), bool)
    if len(cam_ts_arr):
        cam_keep[_dedup(cam_ts_arr)] = True

    f_out = int(lidar_keep.sum())
    images_mm = np.lib.format.open_memmap(
        os.path.join(out_dir, "lidar_frames.npy"), mode="w+",
        dtype=np.float32, shape=(f_out, spec.height, spec.width, 3),
    )
    bev_mm = None
    if bev is not None:
        # the reference sizes this (f_out, bev.height, bev.width, 1), which
        # BevSpec does not have (it raises AttributeError): the raster's
        # shape is (nx, ny, channels), as the in-RAM path writes it
        channels = 1 + bev.with_height_channel + bev.with_intensity_channel
        bev_mm = np.lib.format.open_memmap(
            os.path.join(out_dir, "bev_frames.npy"), mode="w+",
            dtype=np.float32, shape=(f_out, bev.nx, bev.ny, channels),
        )
    cam_mm = None
    if len(cam_ts_arr) and cam_shape is not None:
        cam_mm = np.lib.format.open_memmap(
            os.path.join(out_dir, "camera_frames.npy"), mode="w+",
            dtype=np.uint8, shape=(int(cam_keep.sum()), *cam_shape),
        )
    png_dir = os.path.join(out_dir, "camera")
    if save_png and cam_mm is not None:
        os.makedirs(png_dir, exist_ok=True)

    buf: list[np.ndarray] = []
    out_i = 0

    def flush():
        nonlocal out_i
        if not buf:
            return
        pts = np.full((len(buf), nmax, 4), np.nan, np.float32)
        for j, c in enumerate(buf):
            pts[j, : len(c)] = c
        imgs, bv = _project(pts, spec, bev, device)
        images_mm[out_i : out_i + len(buf)] = imgs
        if bev_mm is not None:
            bev_mm[out_i : out_i + len(buf)] = bv
        out_i += len(buf)
        buf.clear()

    i_lidar = i_cam = cam_out = 0
    for msg in BagReader(bag_path).read_messages():
        if is_lidar(msg):
            if lidar_keep[i_lidar]:
                buf.append(parse_pointcloud2(msg.raw))
                if len(buf) == batch:
                    flush()
            i_lidar += 1
        elif is_camera(msg):
            if cam_keep[i_cam] and cam_mm is not None:
                img, encoding = parse_image(msg.raw)
                frame = process_camera_frame(img, encoding, camera, crop)
                cam_mm[cam_out] = frame
                if save_png:
                    from PIL import Image as PILImage

                    PILImage.fromarray(frame).save(os.path.join(
                        png_dir, f"{int(cam_ts_arr[i_cam])}_image.png"
                    ))
                cam_out += 1
            i_cam += 1
    flush()
    images_mm.flush()
    if bev_mm is not None:
        bev_mm.flush()
    if cam_mm is not None:
        cam_mm.flush()

    report = _write_metadata(
        out_dir, lidar_ts[lidar_keep],
        cam_ts_arr[cam_keep] if len(cam_ts_arr) else None,
        radar_rows, tracklet_xml,
    )
    report["streaming"] = True
    return report
