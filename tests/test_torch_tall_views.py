"""The port at range-view heights other than the default 32 rows, against
JAX on the same seeded numpy inputs.

- The plain connected components (what the CUDA kernel is held to on the
  card) on `parity_inputs.cc_frames` at 1, 33, 63 and 128 rows, width
  201, against JAX's XLA sweeps and its Pallas kernel in interpret mode.
  Tolerance: none (integers). Labels equal, extents equal on foreground
  (background extents are undefined in the reference), the port's
  background constants. Every frame converges under CAP sweeps, so all
  three are the fixed point.
- The direct step with the shipped asset at a 64-beam sensor's 63 x 1801
  range view (`RangeViewSpec(res_v_deg=0.665)`) against the committed
  tests/data/torch_port_golden_tall.npz and against live JAX: `found`
  exactly, poses within POSE_ATOL (1e-4, tests/torch_golden.py).
- The top-4 decode (`decode_batch_multi` through `make_e2e_step`) at 63
  rows on two-vehicle 64-beam scans against JAX, the same tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.make_torch_port_golden import golden_tall_arrays, jax_tall_step
from tests.torch_golden import POSE_ATOL, REPO, asset_configs, load_npz, port_asset_model
from tpufusion.ops.components import connected_components_with_bbox as jax_cc
from tpufusion_torch import RangeViewSpec
from tpufusion_torch._golden import TALL_BEAMS, TALL_RES_V_DEG, wrapped_pose_diff
from tpufusion_torch.data.synthetic import synthesize_beam_multi_vehicle_batch
from tpufusion_torch.ops import cc, components, parity_inputs
from tpufusion_torch.predict import make_e2e_step

GOLDEN_TALL = f"{REPO}/tests/data/torch_port_golden_tall.npz"
TALL = RangeViewSpec(res_v_deg=TALL_RES_V_DEG)
WIDTH = 201
CAP = 4096  # sweeps; the serpentines need ~1,500 at most here
HEIGHTS = (1, 33, 63, 128)


@functools.lru_cache(maxsize=None)
def _port_cc(height: int):
    """{frame name: (mask, the port's plain CC outputs as numpy, sweeps)},
    one frame at a time (the batch's sweeps would run to its slowest)."""
    out = {}
    for name, mask in parity_inputs.cc_frames(0, height, WIDTH).items():
        m = torch.from_numpy(mask)[None]
        _, sweeps = components.propagate(components.init_state(m), m, CAP)
        got = cc.connected_components_with_bbox(m, CAP)
        out[name] = (mask, [t[0].numpy() for t in got], int(sweeps[0]))
    return out


@functools.lru_cache(maxsize=None)
def _jax_cc(impl: str):
    return jax.jit(functools.partial(jax_cc, max_iters=CAP, impl=impl))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("height", HEIGHTS)
def test_plain_cc_matches_jax_at_every_height(height, impl):
    big = components._BIG
    for name, (mask, got, sweeps) in _port_cc(height).items():
        assert sweeps < CAP, f"{name}: the plain sweeps did not converge"
        want = [np.asarray(x) for x in _jax_cc(impl)(jnp.asarray(mask))]
        np.testing.assert_array_equal(got[0], want[0], err_msg=name)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[mask], w[mask], err_msg=name)
        bg = ~mask
        assert (got[0][bg] == -1).all() and (got[1][bg] == big).all()
        assert (got[2][bg] == -big).all() and (got[3][bg] == big).all()
        assert (got[4][bg] == -big).all()


@pytest.mark.parametrize("height", HEIGHTS)
def test_cc_frames_cross_the_row_borders(height):
    """The tall cases aim where they should: the row stripes straddle each
    row border, the comb's teeth meet only through its spine, and each
    serpentine is one path whose plain sweeps stay in their budget."""
    frames = parity_inputs.cc_frames(0, height, WIDTH)
    labels = {n: r[1][0] for n, r in _port_cc(height).items()}
    rows = np.flatnonzero(frames["row_stripes"].any(axis=1))
    borders = range(parity_inputs.TILE_ROWS, height, parity_inputs.TILE_ROWS)
    for r in borders:
        assert r - 1 in rows and r in rows
        # one 2-high bar across each row border
        assert labels["row_stripes"][r - 1, 0] == labels["row_stripes"][r, WIDTH - 1]
    comb = frames["comb_rows"].copy()
    assert len(np.unique(labels["comb_rows"][comb])) == 1
    comb[:, WIDTH // 2] = False  # without the spine the teeth fall apart
    if height > parity_inputs.TILE_ROWS:
        cut = components.connected_components_reference(torch.from_numpy(comb), CAP).numpy()
        assert len(np.unique(cut[comb])) > 2
    for name in ("serpentine", "serpentine_columns"):  # one path each
        assert len(np.unique(labels[name][frames[name]])) == 1
        if height > parity_inputs.TILE_ROWS:  # cut to the sweep budget
            assert _port_cc(height)[name][2] <= parity_inputs.SERPENTINE_SWEEPS + 100


def test_cpu_wrapper_takes_tall_masks():
    """On the CPU every height runs the plain sweeps, never the kernel."""
    mask = torch.from_numpy(parity_inputs.cc_batch(3, height=128, width=WIDTH))
    before = cc.LAUNCHES
    got = cc.connected_components_with_bbox(mask, CAP)
    want = components.connected_components_with_bbox(mask, CAP)
    assert cc.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def tall_golden():
    return load_npz(GOLDEN_TALL)


@pytest.fixture(scope="module")
def direct_step():
    _, dcfg = asset_configs()
    return make_e2e_step(port_asset_model(), TALL, dcfg, head="direct", device="cpu")


def test_direct_step_at_63_rows_matches_the_tall_golden(tall_golden, direct_step):
    g = tall_golden
    assert (TALL.height, TALL.width) == (63, 1801)
    assert g["points"].shape == (4, 32768, 4) and g["found"].all()
    poses, found = direct_step(g["points"], g["valid"])
    assert poses.shape == (4, 7)
    np.testing.assert_array_equal(found.numpy(), g["found"])
    assert wrapped_pose_diff(poses, g["poses"]).max() < POSE_ATOL


def test_direct_step_at_63_rows_matches_live_jax(tall_golden, direct_step):
    """Live JAX on freshly made frames; the golden is current (its frames
    and JAX's answer on them made again)."""
    fresh = golden_tall_arrays()
    np.testing.assert_array_equal(fresh["found"], tall_golden["found"])
    assert wrapped_pose_diff(fresh["poses"], tall_golden["poses"]).max() < POSE_ATOL
    np.testing.assert_allclose(fresh["points"], tall_golden["points"], rtol=0, atol=1e-4)
    poses, found = direct_step(fresh["points"], fresh["valid"])
    np.testing.assert_array_equal(found.numpy(), fresh["found"])
    assert wrapped_pose_diff(poses, fresh["poses"]).max() < POSE_ATOL


def test_topk_decode_at_63_rows_matches_jax():
    """Two-vehicle 64-beam scans through the top-4 step at 63 x 1801."""
    pts, _, valid = synthesize_beam_multi_vehicle_batch(
        np.random.default_rng(61), 2, 32768, n_vehicles=2, n_beams=TALL_BEAMS)
    _, dcfg = asset_configs()
    step = make_e2e_step(port_asset_model(), TALL, dcfg, max_obstacles=4, device="cpu")
    poses, found = step(pts, valid)
    want_poses, want_found = jax_tall_step(pts, valid, k=4)
    assert poses.shape == (2, 4, 7)
    np.testing.assert_array_equal(found.numpy(), want_found)
    assert int(found.sum(dim=1).max()) >= 2  # the top-K keeps a second vehicle
    assert wrapped_pose_diff(poses[found], want_poses[want_found]).max() < POSE_ATOL
