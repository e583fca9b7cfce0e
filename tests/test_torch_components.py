"""Golden tests: the port's connected components against JAX.

Tolerance: none — labels and extents are integers. Extents are compared
on foreground pixels (background extents are undefined in the reference),
and the port's background values are checked separately.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_golden  # noqa: F401  (torch threads under xdist)
from tpufusion.ops.components import connected_components_with_bbox as jax_cc
from tpufusion_torch.ops import cc, components


def _masks(rng, shape, densities, seam=False):
    out = []
    for density in densities:
        m = rng.random(shape) < density
        if seam:  # a blob across the azimuth seam: two components, no wrap
            m[10:20, -101:] = True
            m[10:20, :100] = True
        out.append(m)
    return np.stack(out)


def _assert_matches_jax(masks, impl, max_iters=128):
    got = [t.numpy() for t in components.connected_components_with_bbox(
        torch.from_numpy(masks), max_iters)]
    for b, mask in enumerate(masks):
        want = [np.asarray(x) for x in jax_cc(jnp.asarray(mask), max_iters, impl)]
        np.testing.assert_array_equal(got[0][b], want[0])
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g[b][mask], w[mask])
    return got


def test_twin_matches_jax_xla_small():
    rng = np.random.default_rng(1234)
    _assert_matches_jax(_masks(rng, (32, 181), (0.05, 0.3, 0.6, 0.0)), "xla")


def test_twin_matches_jax_xla_full_width_with_seam_blob():
    rng = np.random.default_rng(7)
    masks = _masks(rng, (32, 1801), (0.0, 0.05, 0.4), seam=True)
    labels = _assert_matches_jax(masks, "xla")[0]
    # the seam blob stays two components (no wrap across column 0/1800)
    assert labels[0, 15, 0] != labels[0, 15, 1800]


def test_twin_matches_jax_pallas_interpret():
    rng = np.random.default_rng(1234)
    _assert_matches_jax(_masks(rng, (32, 181), (0.05, 0.3, 0.6, 0.0)), "pallas")


def test_twin_background_values_and_sweeps():
    rng = np.random.default_rng(3)
    masks = torch.from_numpy(_masks(rng, (32, 181), (0.0, 0.3)))
    labels, min_x, max_x, min_y, max_y = components.connected_components_with_bbox(masks)
    bg = ~masks
    big = components._BIG
    assert (labels[bg] == -1).all()
    assert (min_x[bg] == big).all() and (max_x[bg] == -big).all()
    assert (min_y[bg] == big).all() and (max_y[bg] == -big).all()
    _, sweeps = components.propagate(components.init_state(masks), masks, 128)
    assert sweeps[0] == 1  # an empty frame converges in one sweep
    assert 1 < sweeps[1] < 128


def test_twin_stops_at_max_iters():
    """A frame that needs more sweeps than max_iters stops there, as the
    reference's while_loop does (and its result is then not the fixed
    point)."""
    mask = np.zeros((1, 32, 181), bool)
    mask[:, ::2, :] = True
    mask[:, :, 0] = True  # a comb: labels travel ~180 px along each tooth
    m = torch.from_numpy(mask)
    _, sweeps = components.propagate(components.init_state(m), m, 3)
    assert sweeps.tolist() == [3]
    _assert_matches_jax(mask, "xla", max_iters=3)


@pytest.mark.parametrize("impl", ["auto", "pallas", "xla"])
def test_wrapper_routes_cpu_masks_to_twin(impl):
    rng = np.random.default_rng(4)
    masks = torch.from_numpy(_masks(rng, (32, 181), (0.2, 0.5)))
    before = cc.LAUNCHES
    got = cc.connected_components_with_bbox(masks, 128, impl)
    want = components.connected_components_with_bbox(masks, 128)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cc.LAUNCHES == before


def test_wrapper_rejects_unknown_impl_and_device_tensors():
    masks = torch.zeros((1, 32, 181), dtype=torch.bool)
    with pytest.raises(ValueError, match="impl"):
        cc.connected_components_with_bbox(masks, 128, "scan")
    with pytest.raises(ValueError):  # no plain fallback off the CPU
        cc.connected_components_with_bbox(masks.to("meta"), 128)
