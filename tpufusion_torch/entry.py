"""The flagship's entry points (counterpart of the repo-root `__graft_entry__.py`).

entry()             -> (fn, example_args): the flagship forward, range-view
                       projection + FCN + pose decode on a batch of raw
                       point clouds (the graph `bench.py` times), with its
                       example inputs on `device`
dryrun_multichip(n) -> `parallel/dryrun.py::dryrun_multichip` on n ranks

Both run on the card unless the caller asks for the CPU; without a card
the default raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpufusion_torch.config import DEFAULT
from tpufusion_torch.data.synthetic import synthesize_points_batch
from tpufusion_torch.models.fcn import FCN, uniform_init_
from tpufusion_torch.predict import make_e2e_step

# The shipped detector asset's geometry (its json's "model"): the
# direct-pose head at width 2 with a linear regression output.
FLAGSHIP = dict(head="direct", width_multiplier=2, reg_output_activation="linear")
EXAMPLE_BATCH = 4
EXAMPLE_POINTS = 8192


def entry(device: torch.device | str = "cuda"):
    """(fn, (model, points)): fn(model, points (B, N, 4)) -> (poses (B, 7),
    found (B,)), `make_e2e_step(model, head="direct", max_obstacles=1)` at
    `DEFAULT.decode` with no validity mask (range view, FCN,
    `decode_batch_direct`), on the points' device; the step is built once
    a model and device. The model is the float32 flagship FCN
    (`DEFAULT.model` at FLAGSHIP's geometry, kernels U(-0.05, 0.05) from
    seed 0 by `uniform_init_`); the example is 4 x 8,192 points of
    `synthesize_points_batch` from numpy seed 0. The distributions are the
    reference's; the values are not its values for the same seeds."""
    device = torch.device(device)
    model = FCN(dataclasses.replace(DEFAULT.model, **FLAGSHIP), in_channels=3)
    uniform_init_(model, 0)
    model.to(device).eval()

    steps = {}  # (id(model), device) -> (model, its step); holding the model keeps its id its own

    def fn(model, points):
        key = (id(model), points.device)
        if key not in steps:
            steps[key] = (model, make_e2e_step(model, DEFAULT.range_view, DEFAULT.decode,
                                               head="direct", device=points.device))
        return steps[key][1](points)

    pts, _ = synthesize_points_batch(np.random.default_rng(0), EXAMPLE_BATCH, EXAMPLE_POINTS)
    return fn, (model, torch.from_numpy(pts).to(device))


def dryrun_multichip(n_devices: int, **kwargs) -> dict:
    """`__graft_entry__.dryrun_multichip`'s counterpart: `parallel.dryrun.dryrun_multichip`."""
    from tpufusion_torch.parallel.dryrun import dryrun_multichip as run

    return run(n_devices, **kwargs)
