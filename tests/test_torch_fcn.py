"""Golden tests: the port's FCN against the JAX FCN, in float32 and bf16.

Tolerances (tests/torch_golden.py): in float32, 1e-5 absolute on the two
softmax probabilities, 1e-4 on the regression channels, whose values
reach ~7 m: the two frameworks sum each convolution in another order.
In bf16, 2**-8 on the probabilities and 2**-4 (two bf16 steps at
|x| < 8) on the regression channels: each layer's output is rounded to
bf16, and the two float32 accumulations may round to neighbouring
values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.torch_golden import (
    ASSET,
    BF16_PROB_ATOL,
    BF16_REG_ATOL,
    FCN_PROB_ATOL,
    FCN_REG_ATOL,
    GOLDEN,
    MIXED_ASSET,
    asset_configs,
    jax_asset_model,
    jax_forward,
    load_npz,
    port_asset_model,
    to_jax_config,
)
from tpufusion.geometry.range_view import range_view_project_batch
from tpufusion.models.fcn import FCN as JaxFCN
from tpufusion.models.io import save_state_npz
from tpufusion_torch import ModelConfig, RangeViewSpec
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.io import fcn_from_arrays, load_state_npz


def _compare(jax_model, port_model, images, n_prob=2, atol=(FCN_PROB_ATOL, FCN_REG_ATOL)):
    want = jax_forward(jax_model, images)
    with torch.inference_mode():
        got = port_model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got[..., :n_prob], want[..., :n_prob], rtol=0, atol=atol[0])
    np.testing.assert_allclose(got[..., n_prob:], want[..., n_prob:], rtol=0, atol=atol[1])
    return want, got


def _golden_images():
    """The golden file's two JAX beam scans as JAX range views (32 x 1801)."""
    with np.load(GOLDEN) as z:
        pts, valid = z["points"], z["valid"]
    return np.array(
        range_view_project_batch(
            jnp.asarray(pts), to_jax_config(RangeViewSpec()), jnp.asarray(valid)
        )
    )


def test_fcn_asset_full_width_matches_jax():
    """The shipped direct-head asset (width 2, linear head, 10 channels) on
    two real range views (the golden file's JAX beam scans) at the full
    32 x 1801 geometry."""
    want, _ = _compare(jax_asset_model(), port_asset_model(), _golden_images())
    assert want.shape == (2, 32, 1801, 10)
    assert np.abs(want[..., 2:]).max() > 1.0  # metre-scale channels exercised


@pytest.mark.parametrize("asset", ["synthetic_detector", "synthetic_detector_mixed"])
def test_fcn_bf16_matches_jax_bf16(asset):
    """dtype="bfloat16" (what bench.py and config 5 run): the port's bf16
    FCN against JAX's bf16 FCN, and both against their float32 FCN. On
    these frames the measured maxima are 1.2e-7 (probabilities) and one
    bf16 step, 2**-5, of a |x| in [4, 8) output (regression)."""
    path = ASSET if asset == "synthetic_detector" else MIXED_ASSET
    images = _golden_images()
    port = port_asset_model(path, "bfloat16")
    conv_dtypes = []
    port.conv2.register_forward_hook(lambda m, i, o: conv_dtypes.append(o.dtype))
    want, got = _compare(
        jax_asset_model(path, "bfloat16"), port, images, atol=(BF16_PROB_ATOL, BF16_REG_ATOL)
    )
    assert conv_dtypes == [torch.bfloat16]  # the convolutions ran in bf16
    with torch.inference_mode():
        f32 = port_asset_model(path)(torch.from_numpy(images)).numpy()
    # bf16 moves the output by whole bf16 steps, far beyond float32 noise
    assert np.abs(got - f32).max() > 100 * FCN_REG_ATOL
    assert np.abs(want - f32)[..., :2].max() < 0.05  # yet keeps the heat map


def test_fcn_random_corner_head_width_201_matches_jax(tmp_path):
    """A random-init width-1 corner-head model (relu regression, 26
    channels) on the 32 x 201 geometry of RangeViewSpec(res_h_deg=1.8)."""
    spec = RangeViewSpec(res_h_deg=1.8)
    cfg = ModelConfig()
    jax_model = JaxFCN(to_jax_config(cfg), in_channels=3, rngs=nnx.Rngs(1))
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
    want, _ = _compare(jax_model, port.eval(), images)
    assert want.shape == (2, 32, 201, 26)


def test_fcn_from_arrays_equals_load_state_npz():
    mcfg, _ = asset_configs()
    arrays = load_npz(ASSET)
    a = fcn_from_arrays(arrays, mcfg, device="cpu")
    b = FCN(mcfg)
    load_state_npz(ASSET, b)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_load_rejects_missing_extra_and_misshaped_keys():
    mcfg, _ = asset_configs()
    arrays = load_npz(ASSET)
    missing = dict(arrays)
    del missing["conv1/bias"]
    with pytest.raises(ValueError, match="conv1/bias"):
        fcn_from_arrays(missing, mcfg, device="cpu")
    extra = dict(arrays, **{"conv9/kernel": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="conv9"):
        fcn_from_arrays(extra, mcfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        fcn_from_arrays(arrays, dataclasses.replace(mcfg, width_multiplier=1), device="cpu")


@pytest.mark.parametrize("change", [{"sample_wise_bn": True}])
def test_fcn_options_not_ported_raise(change):
    with pytest.raises(NotImplementedError):
        FCN(dataclasses.replace(ModelConfig(), **change))


def test_fcn_rejects_an_unknown_dtype():
    with pytest.raises(ValueError, match="dtype"):
        FCN(dataclasses.replace(ModelConfig(), dtype="float16"))
