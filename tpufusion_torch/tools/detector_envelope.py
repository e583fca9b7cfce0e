"""The piece of `tpufusion/tools/detector_envelope.py` the benchmarks use
(a copy; `tests/test_torch_imports.py` holds it equal to the original).
The envelope sweep itself (`run_condition`, `main`) waits for the tools
slice (ROADMAP Queue 1)."""

from __future__ import annotations


def base_condition_from_meta(meta: dict) -> dict:
    """Scene kwargs of an asset's training distribution, from its json
    metadata. Missing fields fall back to the flagship's base (32k points,
    max_yaw 0.05, circle surface). A "mixed" asset anchors on the circle
    family, whose yaw cap is min(max_yaw, 0.05): yaw is unobservable on a
    rotationally symmetric surface."""
    base_kw = dict(
        n_points=int(meta.get("n_points", 32768)),
        max_yaw=float(meta.get("max_yaw", 0.05)),
    )
    scenes = str(meta.get("scenes", "beam"))
    if scenes.endswith("ellipse"):
        base_kw["vehicle_surface"] = "ellipse"
    elif scenes.endswith("box"):
        base_kw["vehicle_surface"] = "box"
    elif scenes == "mixed":
        base_kw["max_yaw"] = min(base_kw["max_yaw"], 0.05)
    return base_kw
