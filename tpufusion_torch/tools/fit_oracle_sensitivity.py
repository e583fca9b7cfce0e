"""Oracle-sensitivity A/B for the surface-fit decode (counterpart of
`tpufusion/tools/fit_oracle_sensitivity.py`).

The "fit" center parameterizes the boundary family the scene simulator
renders, which makes its accuracy partly self-referential. This tool
measures how much of the fit's gain is geometry and how much generator
knowledge, on box scenes by default: the one family whose rendered
surface (the true l x w rectangle) shares no inset or scale constant with
any fit boundary. Four arms decode the same prepared batches:

  fit:box      the rectangle-outline fit: matched geometry, no generator
               constant
  fit:ellipse  a deliberately mismatched boundary family
  fit:circle   mismatched and blind to orientation
  consensus    no boundary model at all (the floor)

If box >> {ellipse, circle} ~ consensus, the fit's value is the geometry
model matching the surface, not leaked constants. The fit arms use
fit_surface_scale 1.0, so the boundary shape is the only difference.

    python -m tpufusion_torch.tools.fit_oracle_sensitivity [--asset PATH] [--scenes beam-box]
        [--device cuda]

Prints one row per arm and a JSON summary line. The asset (default: the
shipped flagship) needs the direct head; `benchmarks.asset_model` loads
it and raises on any fault.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from tpufusion_torch.benchmarks import asset_model, detector_asset_path
from tpufusion_torch.config import DEFAULT
from tpufusion_torch.tools.train_synthetic_detector import evaluate, prepare_eval_batches


def arms(dcfg) -> dict:
    """The four decode configs, by arm name."""
    return {
        "fit:box": dataclasses.replace(dcfg, direct_center="fit", fit_boundary="box",
                                       fit_surface_scale=1.0),
        "fit:ellipse": dataclasses.replace(dcfg, direct_center="fit", fit_boundary="ellipse",
                                           fit_surface_scale=1.0),
        "fit:circle": dataclasses.replace(dcfg, direct_center="fit", fit_boundary="circle",
                                          fit_surface_scale=1.0),
        "consensus": dataclasses.replace(dcfg, direct_center="consensus"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--asset", default=None, help="detector asset npz (default: shipped flagship)")
    ap.add_argument("--scenes", default="beam-box", choices=("beam", "beam-ellipse", "beam-box"))
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_batches", type=int, default=4)
    ap.add_argument("--max_yaw", type=float, default=0.4)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model, dcfg, head = asset_model(args.asset or detector_asset_path())
    if head != "direct":
        raise SystemExit(f"needs a direct-pose asset, got head={head!r}")
    spec = DEFAULT.range_view
    # forward pass once; every arm decodes the prepared batches
    prepared = prepare_eval_batches(model, spec, args.batch, seed=args.seed, max_yaw=args.max_yaw,
                                    scenes=args.scenes, n_batches=args.eval_batches,
                                    device=args.device)
    rows = {}
    for name, cfg_m in arms(dcfg).items():
        ev = evaluate(model, spec, cfg_m, head="direct", center=cfg_m.direct_center,
                      prepared=prepared)
        rows[name] = {k: round(float(ev[k]), 4)
                      for k in ("det", "mean_iou", "recall_iou25", "xy_err", "yaw_err")}
        print(f"{name:<12} det {ev['det']:.2f} iou {ev['mean_iou']:.3f} "
              f"r25 {ev['recall_iou25']:.2f} xy {ev['xy_err']:.2f} "
              f"yaw {ev['yaw_err']:.3f}", flush=True)

    print(json.dumps({
        "probe": "fit_oracle_sensitivity",
        "scenes": args.scenes,
        "max_yaw": args.max_yaw,
        "frames": args.batch * args.eval_batches,
        "rows": rows,
    }))
    return rows


if __name__ == "__main__":
    main()
