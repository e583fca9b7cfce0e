"""The corner decode's paths on the card, for a before / after of the
corner vote: bench.py's corner row, the corner head on the shipped
asset's trunk, and config 2's replay.

It uses only entry points that trees of the port from before the corner
vote kernel have too, so the same file times an earlier tree: put that
tree first on the path,

    PYTHONPATH=DIR python tpufusion_torch/tools/bench_corner_row.py [--out FILE]

(DIR an unpacked earlier commit), and in turns with this tree in one call
(earlier, this, this, earlier). Rows, each on the same distinct beam-scan
batches of 64 x 32,768 points (numpy seeds 0, 1, ...; the headline's):
  corner   bench.py's corner row: the default ModelConfig (corner head) in
           bf16 from seed 0 with the deconv6a bias [2, -2]
           (`benchmarks.seeded_fcn`), `make_e2e_step(head="corner")` at
           DecodeConfig's default; `benchmarks.measure` over --sets
           batches (ms between CUDA events, device ms and busy share from
           torch.profiler, peak memory), then its stages each timed apart
           on the same batches (projection, FCN, `decode_batch`), the
           vote's plain composition alone on `decode_batch`'s lanes (device
           ms a call at a time, `kernel_bench.queued_each`), and
           `decode_batch_multi` at k 4's peak memory above its inputs
  hybrid   the same on the shipped asset's trunk with the multi golden's
           corner regression branch in bf16 at the asset's decode
           (phase 8's hybrid steps: its lanes vote real candidates)
  config2  `benchmarks.config2_replay` at its defaults
The card's name and power limit go to stderr first; stdout gets one JSON
line a row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from tpufusion_torch import benchmarks
from tpufusion_torch.benchmarks import CFG, SPEC, card_line, log, measure, point_sets, seeded_fcn
from tpufusion_torch.config import ModelConfig
from tpufusion_torch.decode import decode as td
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.kernel_bench import queued_each, time_ms
from tpufusion_torch.predict import make_e2e_step

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def hybrid_fcn(dev):
    """The shipped asset's trunk with the multi golden's corner regression
    branch, bf16, and the asset's decode config."""
    from tpufusion_torch._golden import hybrid_corner_arrays, load_npz
    from tpufusion_torch.models.io import asset_configs, fcn_from_arrays

    asset = os.path.join(_REPO, "tpufusion", "assets", "synthetic_detector.npz")
    mcfg, dcfg = asset_configs(asset)
    arrays = hybrid_corner_arrays(load_npz(asset), load_npz(os.path.join(
        _REPO, "tests", "data", "torch_port_golden_multi.npz")))
    mcfg = dataclasses.replace(mcfg, head="corner", dtype="bfloat16")
    return fcn_from_arrays(arrays, mcfg, device=dev).eval(), dcfg


def corner_row(name: str, model, dcfg, sets, dev) -> dict:
    """One corner path's readings on `sets` (see the module's doc)."""
    step = make_e2e_step(model, SPEC, dcfg, head="corner", device=dev)
    dt, how = measure(step, sets, 1, dev)
    plain = getattr(td, "corner_vote_reference", td.corner_vote)  # the earlier tree's name
    with torch.inference_mode():
        images = [range_view_project_batch(p, SPEC, v) for p, v in sets]
        preds = [model(im) for im in images]
        lanes = []
        for y, im in zip(preds, images):
            centroid, bbox, _, found = td._find_obstacle_batch(y[..., 1], dcfg)
            xyz, _, _ = td.back_project_2d_to_3d(centroid, bbox, im[..., 0], im[..., 1], SPEC,
                                                 dcfg)
            lanes.append((y, im, bbox[:, None], xyz[:, None], int(found.sum())))
        split = {
            "projection_ms": time_ms(lambda pv: range_view_project_batch(pv[0], SPEC, pv[1]),
                                     sets),
            "fcn_ms": time_ms(model, images),
            "decode_ms": time_ms(lambda yi: td.decode_batch(yi[0], yi[1], SPEC, dcfg),
                                 list(zip(preds, images))),
            "plain_vote_device_ms": queued_each(lambda a: plain(*a[:4], SPEC, dcfg), lanes),
        }
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        td.decode_batch_multi(preds[0], images[0], SPEC, dcfg, 4)
        torch.cuda.synchronize()
        k4_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
    batch = sets[0][0].shape[0]
    return {"row": name, "ms": dt * 1e3, "frames_per_s": batch / dt, **how, **split,
            "k4_decode_peak_above_inputs_mib": k4_mib,
            "found_first_batch": lanes[0][-1], "batch": batch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n_points", type=int, default=32768)
    ap.add_argument("--sets", type=int, default=6)
    ap.add_argument("--rows", default="corner,hybrid,config2")
    ap.add_argument("--out", help="append the rows here as JSON lines")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)  # without a card, raise here
    card = card_line()
    log(f"device: {card}; tree {os.path.dirname(os.path.abspath(td.__file__))}")
    sets = point_sets(args.sets, args.batch, args.n_points, dev)
    rows = []
    for name in args.rows.split(","):
        if name == "corner":
            rows.append(corner_row(name, seeded_fcn(ModelConfig(), 0, dev), CFG.decode, sets, dev))
        elif name == "hybrid":
            rows.append(corner_row(name, *hybrid_fcn(dev), sets, dev))
        elif name == "config2":
            rows.append({"row": name, **benchmarks.config2_replay(dev)})
        else:
            raise SystemExit(f"unknown row {name!r}")
    for r in rows:
        r.update(card=card, tree=os.path.dirname(os.path.abspath(td.__file__)))
        print(json.dumps(r), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
