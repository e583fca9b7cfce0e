"""`tpufusion_torch/entry.py` against the repo-root `__graft_entry__.py`.

The port's `entry()` fn (range view with no validity mask -> the float32
flagship FCN -> `decode_batch_direct(..., 1)` at `DEFAULT.decode`) is run
with the state of JAX's `entry()` carried across, on JAX's example points,
against JAX's fn on the CPU, and against the committed answer in
tests/data/torch_port_golden_bench.npz. JAX's fn runs eagerly: under
jax.jit XLA contracts the projection's x*x + y*y into an FMA, so its
distances move an ulp and a pixel may change winner, which neither eager
JAX nor the port does (ROADMAP Queue 3). Tolerances: `found` exactly,
poses within POSE_ATOL (1e-4, yaw as an angle; tests/torch_golden.py).
"""

import numpy as np
import pytest
import torch

from tests.make_torch_port_golden import golden_entry_arrays
from tests.torch_golden import GOLDEN_BENCH, POSE_ATOL, load_npz
from tpufusion_torch import entry as port_entry
from tpufusion_torch._golden import wrapped_pose_diff
from tpufusion_torch.models.io import load_arrays


@pytest.fixture(scope="module")
def live():
    """JAX's entry() now: its state, example points and eager answer."""
    return golden_entry_arrays()


@pytest.fixture(scope="module")
def committed():
    return {k: v for k, v in load_npz(GOLDEN_BENCH).items() if k.startswith("entry")}


def _port_fn_with(arrays: dict):
    """The port's entry fn and model on the CPU holding `arrays`' entry/* state."""
    fn, (model, _) = port_entry.entry("cpu")
    load_arrays(model, {k.split("/", 1)[1]: v for k, v in arrays.items() if k.startswith("entry/")})
    return fn, model


@pytest.mark.parametrize("source", ["live JAX", "golden"])
def test_entry_fn_matches_the_reference_entry(live, committed, source):
    """The port's fn with JAX's state, on JAX's example, against JAX's fn
    run now and against the committed golden."""
    want = live if source == "live JAX" else committed
    fn, model = _port_fn_with(want)
    poses, found = fn(model, torch.from_numpy(want["entry_points"]))
    assert poses.shape == (4, 7) and found.shape == (4,)
    np.testing.assert_array_equal(found.numpy(), want["entry_found"])
    assert wrapped_pose_diff(poses, want["entry_poses"]).max() < POSE_ATOL
    assert want["entry_found"].all()  # the seeded net finds a cluster in every frame


def test_entry_golden_is_current(live, committed):
    """The golden's entry part equals what JAX's entry() computes now
    (rerun tests/make_torch_port_golden.py bench if not)."""
    assert sorted(committed) == sorted(live)
    for k, v in live.items():
        if k == "entry_poses":
            np.testing.assert_allclose(committed[k], v, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_entry_builds_the_float32_flagship_and_its_example():
    """The model is the flagship geometry in float32 with kernels from
    U(-0.05, 0.05) and the reference's zero biases, the example 4 x 8,192
    points; both are made again alike from their seeds."""
    fn, (model, points) = port_entry.entry("cpu")
    cfg = model.cfg
    assert (cfg.head, cfg.width_multiplier, cfg.reg_output_activation, cfg.dtype) == (
        "direct", 2, "linear", "float32")
    assert points.shape == (4, 8192, 4) and points.dtype == torch.float32
    state = model.state_dict()
    kernels = [v for k, v in state.items() if k.endswith("kernel")]
    assert all(float(k.abs().max()) <= 0.05 for k in kernels)
    assert all(float(v.abs().max()) == 0 for k, v in state.items() if k.endswith("bias"))
    _, (model2, points2) = port_entry.entry("cpu")
    assert torch.equal(points, points2)
    assert all(torch.equal(v, model2.state_dict()[k]) for k, v in state.items())
    poses, found = fn(model, points)
    assert poses.shape == (4, 7) and found.shape == (4,) and torch.isfinite(poses).all()


def test_dryrun_multichip_delegates_to_the_ports_dry_run():
    """entry.dryrun_multichip runs parallel/dryrun.py's dry run, with its
    mesh rule (2 ranks: data only) and its checks, on two gloo ranks."""
    out = port_entry.dryrun_multichip(2, device="cpu")
    assert out["mesh"] == {"data": 2}
