"""The headline's live step (the shipped detector asset,
`make_e2e_step(head="direct")`, bench.py's live row) with its FCN in each
of several dtypes, in turns on the card:

    python -m tpufusion_torch.tools.bench_dtypes [--sets 6] [--out FILE]

The dtypes are DTYPES: float32, bfloat16, float16, float8_e4m3fn and
float8_e5m2 (the small floats compute as XLA does: a float16 convolution
and the rounding epilogue of `csrc/small_float.cu` a layer). Rows, each
on the same distinct beam-scan batches of 64 x 32,768 points (numpy seeds
0, 1, ...; the headline's), in turns: the dtypes in order, then in
reverse, each `benchmarks.measure` over --sets batches (ms between CUDA
events, device ms and busy share from torch.profiler, peak memory),
beside the first batch's found count and the FCN alone on the same
batches' range views (ms between CUDA events). The FCN's float32 output goes to
the direct decode whatever the dtype, so the decode runs the kernel's
float32 instance in every row. The card's name and power limit go to
stderr first; stdout gets one JSON line a row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from tpufusion_torch.bench import BATCH, N_POINTS
from tpufusion_torch.benchmarks import SPEC, card_line, detector_asset_path, log, measure, point_sets
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.kernel_bench import time_ms
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import asset_configs, load_state_npz
from tpufusion_torch.predict import make_e2e_step


DTYPES = ("float32", "bfloat16", "float16", "float8_e4m3fn", "float8_e5m2")  # in turns


def live_step(dtype: str, dev):
    """make_e2e_step of the shipped asset with its FCN in `dtype`, at its
    json's decode and head, and the FCN."""
    path = detector_asset_path()
    mcfg, dcfg = asset_configs(path)
    model = FCN(dataclasses.replace(mcfg, dtype=dtype), in_channels=3)
    load_state_npz(path, model)
    return make_e2e_step(model, SPEC, dcfg, head=mcfg.head, device=dev), model.to(dev).eval()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sets", type=int, default=6)
    ap.add_argument("--out", help="append the rows here as JSON lines")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)  # without a card, raise here
    card = card_line()
    log(f"device: {card}")
    sets = point_sets(args.sets, BATCH, N_POINTS, dev)
    steps = {dt: live_step(dt, dev) for dt in DTYPES}
    with torch.inference_mode():
        images = [range_view_project_batch(p, SPEC, v) for p, v in sets]
    for turn, dt in enumerate(DTYPES + DTYPES[::-1]):
        step, model = steps[dt]
        found = int(step(*sets[0])[1].sum())
        dt_s, how = measure(step, sets, 1, dev)
        with torch.inference_mode():
            fcn_ms = time_ms(model, images)
        row = {"row": "live", "dtype": dt, "turn": turn, "ms": round(dt_s * 1e3, 3),
               "frames_per_s": round(BATCH / dt_s, 1), "found_first_batch": found,
               "fcn_ms": round(fcn_ms, 3), **how, "card": card}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
