"""The corner head's label encode: the port's plain version against JAX's
`encode_label` / `encode_label_batch`, the wrapper of the fused kernel
(`tpufusion_torch/ops/label_encode.py`) on the CPU, and the rotation table
the kernel builds from the plain version's own cos and sin.

The kernel itself runs on the card only (tests/test_torch_cuda.py,
chip_smoke.py), held there bit for bit to the plain version; here the
plain version is held to JAX. Tolerance: the footprint channels equal,
the corner offsets within LABEL_ATOL (1e-5, the codec tests' limit: JAX
contracts the rotation in an einsum, the port rounds it term by term).

The poses are test_torch_train's: 60 on the 360-degree seam, where a
box's corners project to both ends of the image, and boxes 3-40 m away
all round. Negative slice indices cannot come out of project_2d (its
column is atan2's, truncated toward zero from at least -1); the wrap of
negative ones is held on its own in test_torch_train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import LABEL_ATOL, SMALL, _images, _poses, t
from tests.torch_golden import to_jax_config
from tpufusion.geometry import encoding as jax_encoding
from tpufusion_torch.config import RangeViewSpec
from tpufusion_torch.geometry import encoding
from tpufusion_torch.ops import label_encode

SMALL_TALL = RangeViewSpec(res_v_deg=0.665, res_h_deg=1.8)  # 63 x 201: the 64-beam rows
SPECS = {"32_rows": SMALL, "63_rows": SMALL_TALL}
METHODS = label_encode.METHODS


def _boxes(n, seed):
    """n poses: the first half from the seam, the rest from all round."""
    c, s, y = _poses(400, seed=seed)
    pick = np.r_[0:n // 2, 400 - (n - n // 2):400]
    return c[pick], s[pick], y[pick]


def _assert_label(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., :2], want[..., :2])  # the footprint
    np.testing.assert_allclose(got, want, rtol=0, atol=LABEL_ATOL)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("method", METHODS)
def test_plain_encode_label_matches_jax(method, spec_name):
    """Frame by frame against JAX's encode_label, every method, on seam
    and all-round poses."""
    spec = SPECS[spec_name]
    jspec = to_jax_config(spec)
    c, s, y = _boxes(8, seed=3)
    img = _images(8, spec, seed=4)
    fg = 0
    for i in range(8):
        want = np.asarray(jax_encoding.encode_label(
            jnp.asarray(c[i]), jnp.asarray(s[i]), jnp.asarray(y[i]), jnp.asarray(img[i]),
            jspec, method))
        got = encoding.encode_label_reference(t(c[i]), t(s[i]), t(y[i]), t(img[i]), spec,
                                              method).numpy()
        _assert_label(got, want)
        fg += int(want[..., 1].sum())
    assert fg > 0, "no footprint pixel"


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)], ids=["one_frame", "batch", "two_batches"])
def test_encode_label_takes_any_leading_shape(lead):
    """The wrapper on the CPU (the plain version) at leading shapes (),
    (B,) and (2, B) against JAX's encode_label, vmapped as the leading
    shape asks; encode_label_batch against JAX's."""
    jspec = to_jax_config(SMALL)
    n = int(np.prod(lead, dtype=int))
    c, s, y = _boxes(n, seed=5)
    img = _images(n, SMALL, seed=6)
    c, s, y = c.reshape(lead + (3,)), s.reshape(lead + (3,)), y.reshape(lead)
    img = img.reshape(lead + img.shape[1:])
    fn = lambda c_, s_, y_, im: jax_encoding.encode_label(c_, s_, y_, im, jspec)  # noqa: E731
    for _ in lead:
        fn = jax.vmap(fn)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (c, s, y, img))))
    got = encoding.encode_label(t(c), t(s), t(y), t(img), SMALL).numpy()
    _assert_label(got, want)
    if len(lead) == 1:
        want_b = np.asarray(jax_encoding.encode_label_batch(
            *(jnp.asarray(a) for a in (c, s, y, img)), jspec))
        _assert_label(encoding.encode_label_batch(t(c), t(s), t(y), t(img), SMALL).numpy(), want_b)


def test_the_wrapper_sends_cpu_tensors_to_the_plain_version_and_refuses_unknown_methods():
    c, s, y = _boxes(4, seed=7)
    img = t(_images(4, SMALL, seed=8))
    before = label_encode.LAUNCHES
    for method in METHODS:
        got = label_encode.encode_label(t(c), t(s), t(y), img, SMALL, method)
        want = encoding.encode_label_reference(t(c), t(s), t(y), img, SMALL, method)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), method
    assert label_encode.LAUNCHES == before  # no kernel on the CPU
    for fn in (label_encode.encode_label, encoding.encode_label):
        with pytest.raises(ValueError, match="unknown footprint method"):
            fn(t(c), t(s), t(y), img, SMALL, "square")


@pytest.mark.parametrize("spec", [RangeViewSpec(), SMALL, RangeViewSpec(res_v_deg=0.665)],
                         ids=["32x1801", "32x201", "63x1801"])
def test_the_kernels_rotation_table_is_pixel_rotations(spec):
    """The kernel builds R = Rz(theta) Ry(phi) from torch's cos and sin of
    each column and row (`label_encode.pixel_trig`): R00 = c cp, R01 = -s,
    R02 = c sp, R10 = s cp, R11 = c, R12 = s sp, R20 = -sp, R21 = 0, R22 =
    cp, a zero product as +0.0. That is pixel_rotations bit for bit (each
    view has a column at theta = 0, -x_min, where sin is 0), and with it
    the label's per-pixel arithmetic in the kernel's order is the plain
    version's."""
    ct, st, cp, sp = label_encode.pixel_trig(spec, "cpu")
    c, s = ct[None, :].expand(spec.height, -1), st[None, :].expand(spec.height, -1)
    cp, sp = cp[:, None].expand(-1, spec.width), sp[:, None].expand(-1, spec.width)

    def plus_zero(v):
        return torch.where(v == 0, torch.zeros_like(v), v)

    rows = [[c * cp, plus_zero(-s), plus_zero(c * sp)],
            [plus_zero(s * cp), c, plus_zero(s * sp)],
            [plus_zero(-sp), torch.zeros_like(c), cp]]
    table = torch.stack([torch.stack(r, -1) for r in rows], -2)
    want = encoding.pixel_rotations(spec, device="cpu")
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))
    assert bool((st == 0).any())  # a column at theta = 0: the zeros' signs are held

    # the label in the kernel's order, op by op, against the plain version
    cs, ss, ys = _boxes(2, seed=9)
    img = t(_images(2, spec, seed=10))
    for i in range(2):
        want = encoding.encode_label_reference(t(cs[i]), t(ss[i]), t(ys[i]), img[i], spec)
        mask = want[..., 1]
        corners = encoding.box_corners_3d(t(cs[i]), t(ss[i]), t(ys[i]))
        d, h = img[i][..., 0], img[i][..., 1]
        p = (d * c, -d * s, h)
        out = [1.0 - mask, mask]
        for k in range(8):
            v = [corners[k, j] - p[j] for j in range(3)]
            for j in range(3):
                out.append((v[0] * table[..., 0, j] + v[1] * table[..., 1, j]
                            + v[2] * table[..., 2, j]) * mask)
        got = torch.stack(out, -1)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
