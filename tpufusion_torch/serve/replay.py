"""Streaming replay server with latency / throughput accounting
(counterpart of `tpufusion/serve/replay.py`).

The serving loop config 2 is named after: a host loop over stored frames
feeds chunks to one fused step (projection + FCN + decode) and stays one
chunk ahead, so the next chunk's host-to-device copy overlaps the current
chunk's compute. With `host_ring` >= 2 every copy goes through a fixed
ring of staging slots: a pinned host buffer, a device buffer and an event
each. The copy runs `non_blocking` on a copy stream and records the
slot's event; the compute stream waits on that event just before the
step that consumes the chunk. A slot is rewritten only after its last
transfer has left the host buffer (the event) and the step that read its
device buffer has returned its poses to the host, which holds for two or
more slots. On the CPU the loop is the same with plain buffers and no
streams. `host_ring` = 0 hands each chunk to `Tensor.to(device)`
directly.

Unlike the reference harness, the step is built with the model's own head
(`head=cfg.model.head`), as `LidarPipeline`'s is, so a direct-head asset
decodes through the direct decode.

`profile_dir` captures a torch.profiler trace of the timed window into
`profile_dir/replay_trace.json`.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT, PipelineConfig
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.predict import make_e2e_step


@dataclasses.dataclass
class LatencyStats:
    batch_seconds: list
    batch_size: int

    @property
    def frames(self) -> int:
        return len(self.batch_seconds) * self.batch_size

    def percentile_ms(self, q: float) -> float:
        per_frame = np.asarray(self.batch_seconds) / self.batch_size
        return float(np.percentile(per_frame, q) * 1e3)

    @property
    def throughput_fps(self) -> float:
        return self.frames / float(np.sum(self.batch_seconds))

    def summary(self) -> dict:
        return {
            "frames": self.frames,
            "fps": round(self.throughput_fps, 1),
            "p50_ms_per_frame": round(self.percentile_ms(50), 3),
            "p99_ms_per_frame": round(self.percentile_ms(99), 3),
        }


class ReplayHarness:
    def __init__(
        self,
        cfg: PipelineConfig = DEFAULT,
        model: FCN | None = None,
        chunk: int = 64,
        host_ring: int = 0,
        device: torch.device | str = "cuda",
    ):
        """A missing model is a fresh FCN drawn from seed 0 (the
        reference's initialiser's distribution, not its values). The model
        is moved to `device`: the card unless the caller asks for "cpu"
        (without a card, "cuda" raises). host_ring is 0 (no
        staging ring) or the number of staging slots, at least 2: with
        one slot the next chunk would overwrite a buffer whose transfer
        may still be in flight."""
        if host_ring == 1 or host_ring < 0:
            raise ValueError("host_ring must be 0 or >= 2 (the copies are asynchronous)")
        self.cfg = cfg
        self.chunk = chunk
        self.device = torch.device(device)
        self.model = model if model is not None else FCN(cfg.model, in_channels=3, seed=0)
        self._host_ring = host_ring
        self._ring: list | None = None
        self._step = make_e2e_step(
            self.model, cfg.range_view, cfg.decode, cfg.projection_method,
            head=cfg.model.head, device=self.device,
        )
        self._on_card = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if self._on_card else None

    def _make_ring(self, shape: tuple[int, ...]) -> list:
        ring = []
        for _ in range(self._host_ring):
            host = torch.empty(shape, dtype=torch.float32, pin_memory=self._on_card)
            if self._on_card:
                dev = torch.empty(shape, dtype=torch.float32, device=self.device)
                ring.append((host, dev, torch.cuda.Event()))
            else:
                ring.append((host, host, None))
        return ring

    def _stage(self, host_chunk: np.ndarray, slot: int):
        """Starts chunk's host-to-device transfer; returns (tensor on the
        device, the event its consumer must wait on or None)."""
        src = torch.from_numpy(np.ascontiguousarray(host_chunk, dtype=np.float32))
        if not self._host_ring:
            return src.to(self.device), None
        if self._ring is None:
            self._ring = self._make_ring(tuple(src.shape))
        host, dev, event = self._ring[slot % self._host_ring]
        if event is None:
            host.copy_(src)
            return dev, None
        event.synchronize()  # the slot's last transfer has left the host buffer
        host.copy_(src)
        with torch.cuda.stream(self._copy_stream):
            dev.copy_(host, non_blocking=True)
            event.record()
        return dev, event

    def _take(self, staged) -> torch.Tensor:
        """The staged chunk, once the compute stream waits on its copy."""
        tensor, event = staged
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        return tensor

    def run(
        self,
        points: np.ndarray,  # (F, N, 4) stored frames
        profile_dir: str | None = None,
    ) -> tuple[np.ndarray, np.ndarray, LatencyStats]:
        """Returns (poses (F, 7), found (F,), LatencyStats): every frame
        is answered; the trailing partial chunk is padded by repeating the
        last frame and the padding is dropped from the result."""
        f = len(points)
        if f == 0:
            raise ValueError("need at least one frame")
        nb = (f + self.chunk - 1) // self.chunk
        pad = nb * self.chunk - f
        if pad:
            points = np.concatenate([points, np.repeat(points[-1:], pad, axis=0)])
        poses = np.zeros((nb * self.chunk, 7), np.float32)
        founds = np.zeros((nb * self.chunk,), bool)

        # warm-up (the kernels' build, cuDNN's plans) outside the timed window
        p, fd = self._step(self._take(self._stage(points[: self.chunk], 0)))
        p.cpu()

        profiler = None
        if profile_dir is not None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self._on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=acts)
            profiler.start()
        times = []
        try:
            pending = self._stage(points[: self.chunk], 0)
            for b in range(nb):
                t0 = time.perf_counter()
                batch = self._take(pending)
                if b + 1 < nb:  # stay one transfer ahead
                    pending = self._stage(
                        points[(b + 1) * self.chunk : (b + 2) * self.chunk], b + 1
                    )
                p, fd = self._step(batch)
                lo = b * self.chunk
                poses[lo : lo + self.chunk] = p.cpu().numpy()
                founds[lo : lo + self.chunk] = fd.cpu().numpy()
                times.append(time.perf_counter() - t0)
        finally:
            if profiler is not None:
                profiler.stop()
        if profiler is not None:
            os.makedirs(profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(profile_dir, "replay_trace.json"))

        return poses[:f], founds[:f], LatencyStats(times, self.chunk)
