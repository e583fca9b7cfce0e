"""Live browser-based viewer (counterpart of `tpufusion/serve/viewer.py`):
named "windows" (range view, BEV, class mask, camera) streamed to any
browser over HTTP as MJPEG, with no client-side code.

`LiveViewer.push(name, frame)` updates the latest frame of a window and
every connected browser sees it through a multipart stream (`/stream/<w>`);
`/frame/<w>` returns the latest JPEG and `/` lists the windows. The server
is a copy of the reference's; the frames are JPEG-encoded by the port's
own numpy encoder (`serve/jpeg.py`, the bytes `cv2.imencode` writes at
quality 88), so the viewer runs on a host without OpenCV, such as the
card's.

Usage:
    viewer = LiveViewer(port=8642)
    viewer.start()
    viewer.push("range_view", rgb_u8)   # any (H, W[, 3]) uint8/float
    ...
    viewer.stop()

or end to end: `python -m tpufusion_torch.cli view <dataset_dir or
points.npz>` replays a dataset through the range view (+ the BEV for raw
points, + the class mask with a checkpoint of `cli train`) on `--device`
and streams the renders.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from tpufusion_torch.serve.jpeg import encode_jpeg

_INDEX = """<!doctype html>
<html><head><title>tpufusion live</title>
<style>
 body {{ background: #111; color: #ddd; font-family: monospace; }}
 .win {{ margin: 12px; display: inline-block; vertical-align: top; }}
 img {{ max-width: 96vw; image-rendering: pixelated; border: 1px solid #444; }}
 h3 {{ margin: 2px 0; }}
</style></head><body>
<h2>tpufusion live viewer</h2>
{windows}
</body></html>"""


def _encode_jpeg(frame: np.ndarray) -> bytes:
    if frame.dtype != np.uint8:
        lo, hi = float(np.min(frame)), float(np.max(frame))
        frame = (
            np.zeros_like(frame, np.uint8)
            if hi <= lo
            else ((frame - lo) / (hi - lo) * 255).astype(np.uint8)
        )
    return encode_jpeg(frame, quality=88)


class LiveViewer:
    """Thread-backed HTTP server streaming named frame windows (MJPEG)."""

    def __init__(self, port: int = 8642, host: str = "0.0.0.0"):
        self.host, self.port = host, port
        self._frames: dict[str, bytes] = {}
        self._seq: dict[str, int] = {}
        self._cond = threading.Condition()
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # -- producer side ----------------------------------------------------
    def push(self, name: str, frame: np.ndarray) -> None:
        """Update window `name` with a (H, W[, 3]) array (any dtype)."""
        data = _encode_jpeg(np.asarray(frame))
        with self._cond:
            self._frames[name] = data
            self._seq[name] = self._seq.get(name, 0) + 1
            self._cond.notify_all()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    return self._index()
                if self.path.startswith("/frame/"):
                    return self._frame(self.path[len("/frame/"):])
                if self.path.startswith("/stream/"):
                    return self._stream(self.path[len("/stream/"):])
                self.send_error(404)

            def _index(self):
                with viewer._cond:
                    names = sorted(viewer._frames) or ["(no frames yet)"]
                wins = "\n".join(
                    f'<div class="win"><h3>{n}</h3>'
                    f'<img src="/stream/{n}"></div>'
                    if not n.startswith("(")
                    else f"<p>{n}</p>"
                    for n in names
                )
                body = _INDEX.format(windows=wins).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _frame(self, name):
                with viewer._cond:
                    data = viewer._frames.get(name)
                if data is None:
                    return self.send_error(404, f"no window {name!r}")
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _stream(self, name):
                with viewer._cond:
                    known = name in viewer._frames
                if not known:
                    # match /frame: an unknown window 404s instead of
                    # pinning a server thread on a forever-empty stream
                    return self.send_error(404, f"no window {name!r}")
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                last = -1
                try:
                    while True:
                        with viewer._cond:
                            viewer._cond.wait_for(
                                lambda: viewer._seq.get(name, 0) != last,
                                timeout=1.0,
                            )
                            data = viewer._frames.get(name)
                            last = viewer._seq.get(name, 0)
                        if data is None:
                            continue
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(data)}\r\n\r\n".encode()
                        )
                        self.wfile.write(data)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass  # browser went away

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def view_dataset(
    path: str,
    checkpoint: str | None = None,
    port: int = 8642,
    rate_hz: float = 10.0,
    loop: bool = False,
    device: torch.device | str = "cuda",
) -> None:
    """Replay a dataset through the pipeline and stream range-view
    (+ BEV for raw point files, + class-mask with a checkpoint) renders —
    the `rosplayback` + pyglet-viewers workflow, in a browser.

    `path` is either an extracted dataset dir (lidar_frames.npz of
    projected range views, cli extract's output) or a raw .npz with a
    `points` (F, N, 4) array (cli extract's input), which also gets the
    BEV window. The range view (`range_view_project`, one z-buffer launch
    a frame), the BEV and the FCN run on `device`; `checkpoint` is a
    checkpoint directory of `cli train` (`train/checkpoint.py`'s
    `ckpt_<step>.pt`, not the reference's orbax checkpoint) holding
    `FCN(DEFAULT.model)`."""
    from tpufusion_torch.config import DEFAULT, BevSpec
    from tpufusion_torch.geometry.bev import bev_rasterize
    from tpufusion_torch.geometry.range_view import range_view_project
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.tools.visualize import (
        render_bev,
        render_class_mask,
        render_range_view,
    )

    device = torch.device(device)
    spec = DEFAULT.range_view
    bev_spec = BevSpec()
    points = None
    if path.endswith(".npz"):
        points = np.load(path)["points"]
        n_frames = len(points)
    else:
        from tpufusion_torch.data.etl import load_extracted

        images = load_extracted(path)["images"]
        n_frames = len(images)

    model = None
    if checkpoint is not None:
        from tpufusion_torch.train.checkpoint import CheckpointManager

        model = FCN(DEFAULT.model, in_channels=3, seed=0)
        CheckpointManager(checkpoint).restore(model, device=device)
        model.eval()

    def class_prob(img: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            preds = model(torch.from_numpy(np.asarray(img, np.float32)[None]).to(device))
            return torch.softmax(preds[0, ..., :2].float(), dim=-1)[..., 1].cpu().numpy()

    viewer = LiveViewer(port=port).start()
    print(f"live viewer: http://localhost:{viewer.port}/  "
          f"({n_frames} frames at {rate_hz} Hz"
          + (", looping" if loop else "") + ")", flush=True)
    try:
        while True:
            for i in range(n_frames):
                t0 = time.time()
                if points is not None:
                    pts = torch.from_numpy(np.asarray(points[i], np.float32)).to(device)
                    with torch.inference_mode():
                        img = range_view_project(pts, spec).cpu().numpy()
                        bev = bev_rasterize(pts, bev_spec).cpu().numpy()
                    viewer.push("bev", render_bev(bev, spec=bev_spec))
                else:
                    img = np.asarray(images[i])
                viewer.push("range_view", render_range_view(img, spec=spec))
                if model is not None:
                    viewer.push("class_mask", render_class_mask(class_prob(img)))
                dt = 1.0 / rate_hz - (time.time() - t0)
                if dt > 0:
                    time.sleep(dt)
            if not loop:
                break
    except KeyboardInterrupt:
        pass
    finally:
        viewer.stop()
