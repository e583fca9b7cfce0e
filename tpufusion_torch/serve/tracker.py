"""Multi-frame pose tracking over per-frame detections: the port's copy
of the JAX package's numpy tracker (`tpufusion/serve/tracker.py`:
`Track`, `PoseTracker`, `track_quality_metrics`), held equal to it by
`tests/test_torch_multi.py`.

A host-side constant-velocity tracker over the per-frame device
detections: gating by distance, exponential smoothing of pose and size,
coasting through missed frames, and track retirement. Per-frame cost is a
few scalar ops; it never touches the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Track:
    track_id: int
    pose: np.ndarray  # (7,) tx ty tz rz l w h
    velocity: np.ndarray  # (3,)
    last_seen: int
    min_hits: int = 3
    min_hit_ratio: float = 0.6
    hits: int = 1
    age: int = 1
    # detections associated BEFORE the track confirmed, as (internal
    # frame, pose): the n-of-m confirmation gate delays reporting by
    # min_hits frames, but once a track proves real those early
    # detections were real too — run_multi retroactively attaches them
    # (free offline, zero spurious cost: never-confirmed clutter tracks
    # still emit nothing)
    backfill: list = dataclasses.field(default_factory=list)

    @property
    def confirmed(self) -> bool:
        # n-of-m confirmation: enough hits AND a healthy hit rate over the
        # track's lifetime. hits>=2 alone let any clutter cluster that
        # flickered twice inside the coast window become a track (the two
        # spurious tracks of round 2's config 5).
        return (
            self.hits >= self.min_hits
            and self.hits / max(self.age, 1) >= self.min_hit_ratio
        )


class PoseTracker:
    def __init__(
        self,
        gate_m: float = 5.0,
        smooth: float = 0.5,
        max_coast: int = 5,
        dt: float = 0.1,
        min_hits: int = 3,
        min_hit_ratio: float = 0.6,
    ):
        self.gate_m = gate_m
        self.smooth = smooth
        self.max_coast = max_coast
        self.dt = dt
        self.min_hits = min_hits
        self.min_hit_ratio = min_hit_ratio
        self.tracks: list[Track] = []
        self._next_id = 1
        self._frame = 0

    def _predict(self, t: Track) -> np.ndarray:
        p = t.pose.copy()
        p[:3] += t.velocity * self.dt * (self._frame - t.last_seen)
        return p

    def step(self, detections: np.ndarray, found: np.ndarray) -> list[Track]:
        """detections (K, 7) poses for one frame (K=1 for this pipeline);
        found (K,) validity. Returns live confirmed tracks."""
        self._frame += 1
        dets = [d for d, ok in zip(np.atleast_2d(detections), found) if ok]
        unmatched = list(range(len(dets)))

        # every live track ages every frame — aging only inside the
        # association loop undercounts (the loop breaks early once all
        # detections are matched, and never runs on empty frames), which
        # let intermittent clutter keep hits/age ~ 1.0 and defeat the
        # n-of-m gate
        for t in self.tracks:
            t.age += 1

        # greedy nearest association, gated
        for t in sorted(self.tracks, key=lambda t: -t.hits):
            if not unmatched:
                break
            pred = self._predict(t)
            dists = [
                np.linalg.norm(dets[i][:3] - pred[:3]) for i in unmatched
            ]
            j = int(np.argmin(dists))
            if dists[j] <= self.gate_m:
                i = unmatched.pop(j)
                det = np.asarray(dets[i], np.float64)
                gap = max(self._frame - t.last_seen, 1)
                new_v = (det[:3] - t.pose[:3]) / (self.dt * gap)
                t.velocity = self.smooth * t.velocity + (1 - self.smooth) * new_v
                t.pose = self.smooth * t.pose + (1 - self.smooth) * det
                t.last_seen = self._frame
                t.hits += 1

        for i in unmatched:
            self.tracks.append(
                Track(
                    track_id=self._next_id,
                    pose=np.asarray(dets[i], np.float64),
                    velocity=np.zeros(3),
                    last_seen=self._frame,
                    min_hits=self.min_hits,
                    min_hit_ratio=self.min_hit_ratio,
                )
            )
            self._next_id += 1

        self.tracks = [
            t
            for t in self.tracks
            if self._frame - t.last_seen <= self.max_coast
        ]
        # record pre-confirmation DETECTIONS (not coast predictions —
        # a 1-2-hit velocity estimate is too noisy to backfill) for
        # retroactive attachment once the track confirms
        for t in self.tracks:
            if not t.confirmed and t.last_seen == self._frame:
                t.backfill.append((self._frame, t.pose.copy()))
        return [t for t in self.tracks if t.confirmed]

    def run_multi(
        self, poses: np.ndarray, founds: np.ndarray
    ) -> dict[int, list[tuple[int, np.ndarray]]]:
        """Online tracking over a multi-detection sequence: poses (F, K, 7),
        founds (F, K) -> {track_id: [(frame, pose), ...]} for every track
        that was ever confirmed. On first confirmation, a track's
        pre-confirmation detections are backfilled into its trail
        (retroactive association — the confirmation gate is a reporting
        delay, not evidence the early detections were wrong; measured on
        config 5's 2-vehicle sequence: coverage 0.84 -> 0.94 at
        unchanged 0 spurious / 0 ID switches / 0 fragmentation)."""
        trails: dict[int, list[tuple[int, np.ndarray]]] = {}
        for f in range(len(poses)):
            for t in self.step(poses[f], np.asarray(founds[f])):
                trail = trails.get(t.track_id)
                if trail is None:
                    # step()'s internal frame counter is 1-based
                    trail = trails[t.track_id] = [
                        (fr - 1, p) for fr, p in t.backfill
                    ]
                trail.append((f, self._predict(t)))
        return trails

    def run(self, poses: np.ndarray, founds: np.ndarray) -> np.ndarray:
        """Offline smoothing over a sequence: (F, 7), (F,) -> (F, 7) poses
        of the dominant track (coasted through misses; zeros before the
        first confirmation)."""
        out = np.zeros_like(np.asarray(poses, np.float64))
        for f in range(len(poses)):
            live = self.step(poses[f][None], np.asarray([founds[f]]))
            if live:
                best = max(live, key=lambda t: t.hits)
                out[f] = self._predict(best)
        return out


def track_quality_metrics(
    trails: dict[int, list[tuple[int, np.ndarray]]],
    gt_centers: np.ndarray,  # (F, V, 3) per-frame ground-truth centers
    match_dist: float = 2.5,
) -> dict:
    """MOT-style quality decomposition of PoseTracker.run_multi output.

    Per (frame, vehicle), the matched track is the trail whose pose that
    frame lies within match_dist (xy). Reports:
      vehicles_tracked — GT vehicles matched in at least 3 frames
      spurious_tracks  — trails that never match any vehicle
      id_switches      — times a vehicle's matched track id CHANGES
                         between consecutive matched frames
      fragmentation    — extra distinct tracks per vehicle beyond the
                         first (sum over vehicles)
      coverage         — matched (frame, vehicle) pairs / total
    The reference has no tracker and no metrics like these (SURVEY §2.2).
    """
    f, v = gt_centers.shape[:2]
    # frame -> {track_id: pose}
    by_frame: dict[int, dict[int, np.ndarray]] = {}
    for tid, trail in trails.items():
        for fr, pose in trail:
            by_frame.setdefault(fr, {})[tid] = pose

    matched_ids = {vi: [] for vi in range(v)}  # sequence of (frame, tid)
    used_tracks = set()
    matched_pairs = 0
    for fr in range(f):
        frame_tracks = by_frame.get(fr, {})
        if not frame_tracks:
            continue
        tids = list(frame_tracks)
        poses = np.asarray([frame_tracks[t][:2] for t in tids])
        taken = set()
        for vi in range(v):
            d = np.linalg.norm(poses - gt_centers[fr, vi, :2], axis=1)
            order = np.argsort(d)
            for j in order:
                if d[j] > match_dist:
                    break
                if tids[j] in taken:
                    continue
                taken.add(tids[j])
                used_tracks.add(tids[j])
                matched_ids[vi].append((fr, tids[j]))
                matched_pairs += 1
                break

    id_switches = 0
    fragmentation = 0
    vehicles_tracked = 0
    for vi in range(v):
        seq = matched_ids[vi]
        if len(seq) >= 3:
            vehicles_tracked += 1
        ids = [tid for _, tid in seq]
        id_switches += sum(
            1 for a, b in zip(ids, ids[1:]) if a != b
        )
        fragmentation += max(len(set(ids)) - 1, 0)

    return {
        "vehicles_tracked": vehicles_tracked,
        "vehicles_total": v,
        "spurious_tracks": len(set(trails) - used_tracks),
        "id_switches": id_switches,
        "fragmentation": fragmentation,
        "coverage": round(matched_pairs / max(f * v, 1), 3),
    }
