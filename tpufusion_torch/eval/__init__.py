"""Pose scoring, interpolation, the tracklet XML and the submission
writers (numpy, host side); exports the names of
`tpufusion/eval/__init__.py`."""

from tpufusion_torch.eval.interpolate import interpolate_poses, load_timestamps_csv
from tpufusion_torch.eval.scoring import (
    box_iou_3d,
    orbit_to_physical,
    physical_to_orbit,
    pose_errors,
    score_poses,
)
from tpufusion_torch.eval.submission import generate_submission
from tpufusion_torch.eval.tracklet_xml import Tracklet, TrackletCollection, parse_tracklet_xml

__all__ = [
    "Tracklet",
    "TrackletCollection",
    "parse_tracklet_xml",
    "interpolate_poses",
    "load_timestamps_csv",
    "pose_errors",
    "box_iou_3d",
    "orbit_to_physical",
    "physical_to_orbit",
    "score_poses",
    "generate_submission",
]
