"""The port's Keras importer (`tpufusion_torch/tools/import_keras.py`)
against the JAX package's, on the CPU.

The reference's trained `lidar_model.h5` is not in the repository, so each
test writes its own file with the shipped layout (`normalize`, `conv1` ..
`deconv6a`) and seeded weights (`tests/torch_golden.py::write_shipped_h5`)
at 32 x 201 and at 32 x 1801. Limits: the port's imported model against
the JAX importer's, 1e-5 (both float32, the same graph); against the
numpy forward of the h5 graph (`tests/oracle/keras_numpy.py`), the
reference's own 1e-4. The conversion of a transposed kernel is held equal
to the reference's, and the port's ConvTranspose with the converted kernel
to the gradient of the strided SAME conv that Keras's Conv2DTranspose is,
within 1e-4 (the reference's limit).
"""

import numpy as np
import pytest
import torch

from tests.torch_golden import range_view_inputs, write_shipped_h5
from tpufusion_torch.models.fcn import Conv, ConvTranspose
from tpufusion_torch.tools import import_keras


@pytest.fixture
def h5py():
    return pytest.importorskip("h5py")


@pytest.mark.parametrize("stride", [(1, 2), (1, 4), (2, 2)])
def test_conv_transpose_matches_conv_gradient(stride, rng):
    from tpufusion.tools.import_keras import keras_deconv_to_flax

    cin, cout, h, w = 6, 4, 16, 32
    keras_kernel = rng.normal(size=(5, 5, cout, cin)).astype(np.float32)
    converted = import_keras.keras_deconv_to_flax(keras_kernel)
    np.testing.assert_array_equal(converted, keras_deconv_to_flax(keras_kernel))

    # the forward conv consumes the transpose's output channels and makes
    # its input channels: the stored (kh, kw, out, in) kernel is its HWIO
    conv = Conv(cout, cin, stride)
    conv.kernel.data = torch.from_numpy(keras_kernel)
    g = torch.from_numpy(rng.normal(size=(1, cin, h, w)).astype(np.float32))
    x0 = torch.zeros(1, cout, h * stride[0], w * stride[1], requires_grad=True)
    (want,) = torch.autograd.grad(conv(x0), x0, g)

    layer = ConvTranspose(cin, cout, stride)
    layer.kernel.data = torch.from_numpy(converted)
    with torch.no_grad():
        got = layer(g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("width", [201, 1801])
def test_imported_model_matches_the_jax_importer_and_the_numpy_forward(width, h5py, tmp_path):
    import jax.numpy as jnp

    from tests.oracle.keras_numpy import shipped_model_forward
    from tpufusion.tools.import_keras import load_reference_fcn

    path = str(tmp_path / "lidar_model.h5")
    write_shipped_h5(path, (32, width), seed=width)
    x = range_view_inputs(seed=7, batch=2, width=width)
    model = import_keras.load_reference_fcn(path, (32, width), device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(load_reference_fcn(path, (32, width))(jnp.asarray(x), train=False))
    assert got.shape == (2, 32, width, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, shipped_model_forward(path, x), rtol=1e-4, atol=1e-4)
    assert 0.01 < got[..., 1].mean() < 0.99 and got.min() >= 1e-7  # not saturated


def test_importer_rejects_what_is_not_the_shipped_layout(h5py, tmp_path):
    head = str(tmp_path / "regression.h5")
    write_shipped_h5(head, (32, 201), seed=1, extra_layer="deconv5b")
    with pytest.raises(ValueError, match="regression-head h5 is not the shipped artifact layout"):
        import_keras.load_reference_fcn(head, (32, 201), device="cpu")
    wrong = str(tmp_path / "positions.h5")
    write_shipped_h5(wrong, (32, 201), seed=1, positions=32 * 200)
    with pytest.raises(ValueError, match="normalize has 6400 positions, expected 6432"):
        import_keras.load_reference_fcn(wrong, (32, 201), device="cpu")
