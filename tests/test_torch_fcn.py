"""Golden tests: the port's FCN against the JAX FCN, in float32.

Tolerances (tests/torch_golden.py): 1e-5 absolute on the two softmax
probabilities, 1e-4 on the regression channels, whose values reach ~7 m:
the two frameworks sum each convolution in another order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.torch_golden import (
    ASSET,
    FCN_PROB_ATOL,
    FCN_REG_ATOL,
    GOLDEN,
    asset_configs,
    jax_asset_model,
    jax_forward,
)
from tpufusion.config import ModelConfig, RangeViewSpec
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import FCN as JaxFCN
from tpufusion.models.io import save_state_npz
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import fcn_from_arrays, load_state_npz


def _compare(jax_model, port_model, images, n_prob=2):
    want = jax_forward(jax_model, images)
    with torch.inference_mode():
        got = port_model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :n_prob], want[..., :n_prob], rtol=0, atol=FCN_PROB_ATOL)
    np.testing.assert_allclose(got[..., n_prob:], want[..., n_prob:], rtol=0, atol=FCN_REG_ATOL)
    return want


def test_fcn_asset_full_width_matches_jax():
    """The shipped direct-head asset (width 2, linear head, 10 channels) on
    two real range views (the golden file's JAX beam scans) at the full
    32 x 1801 geometry."""
    with np.load(GOLDEN) as z:
        pts, valid = z["points"], z["valid"]
    images = np.array(
        range_view_project_batch(jnp.asarray(pts), RangeViewSpec(), jnp.asarray(valid))
    )
    mcfg, _ = asset_configs()
    port = FCN(mcfg)
    load_state_npz(ASSET, port)
    want = _compare(jax_asset_model(), port.eval(), images)
    assert want.shape == (2, 32, 1801, 10)
    assert np.abs(want[..., 2:]).max() > 1.0  # metre-scale channels exercised


def test_fcn_random_corner_head_width_201_matches_jax(tmp_path):
    """A random-init width-1 corner-head model (relu regression, 26
    channels) on the 32 x 201 geometry of RangeViewSpec(res_h_deg=1.8)."""
    spec = RangeViewSpec(res_h_deg=1.8)
    cfg = ModelConfig()
    jax_model = JaxFCN(cfg, in_channels=3, rngs=nnx.Rngs(1))
    save_state_npz(str(tmp_path / "m.npz"), jax_model)
    port = FCN(cfg)
    load_state_npz(str(tmp_path / "m.npz"), port)
    rng = np.random.default_rng(0)
    images = np.stack(
        [
            rng.uniform(0, 40, (2, spec.height, spec.width)),
            rng.uniform(-2, 2, (2, spec.height, spec.width)),
            rng.uniform(0, 90, (2, spec.height, spec.width)),
        ],
        axis=-1,
    ).astype(np.float32)
    want = _compare(jax_model, port.eval(), images)
    assert want.shape == (2, 32, 201, 26)


def test_fcn_from_arrays_equals_load_state_npz():
    mcfg, _ = asset_configs()
    with np.load(ASSET) as z:
        arrays = {k: z[k] for k in z.files}
    a = fcn_from_arrays(arrays, mcfg)
    b = FCN(mcfg)
    load_state_npz(ASSET, b)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_load_rejects_missing_extra_and_misshaped_keys():
    mcfg, _ = asset_configs()
    with np.load(ASSET) as z:
        arrays = {k: z[k] for k in z.files}
    missing = dict(arrays)
    del missing["conv1/bias"]
    with pytest.raises(ValueError, match="conv1/bias"):
        fcn_from_arrays(missing, mcfg)
    extra = dict(arrays, **{"conv9/kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="conv9"):
        fcn_from_arrays(extra, mcfg)
    with pytest.raises(ValueError, match="shape"):
        fcn_from_arrays(arrays, dataclasses.replace(mcfg, width_multiplier=1))


@pytest.mark.parametrize(
    "change", [{"sample_wise_bn": True}, {"dtype": "bfloat16"}]
)
def test_fcn_options_not_ported_raise(change):
    with pytest.raises(NotImplementedError):
        FCN(dataclasses.replace(ModelConfig(), **change))
