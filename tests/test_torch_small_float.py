"""The small-float and complex configurations against JAX, on the CPU.

The nine small-float names JAX's FCN runs (`ops/small_float.py`
FORMATS): the plain rounding against ml_dtypes code for code (every
float16 pattern through float16, float32 values and the formats' edges
directly, every code decoded); the port's FCN against JAX's bit for bit
on two golden frames cut to 201 columns (probabilities within
F8_PROB_ATOL, the regression outputs and the features' codes equal, NaNs
where JAX's are, a NaN's sign included); the same FCN without the float16
step that XLA rounds each convolution through (a fault) differing from
JAX; the f8 golden (`tests/data/torch_port_golden_f8.npz`, the card's
reference) against the port and against JAX run here; `make_e2e_step`
with the asset in float8_e4m3fn and float8_e5m2 against JAX's step
(found equal, poses within POSE_ATOL). complex64 and complex128: the
float32 net's output, complex64 features and JAX's warnings. Training in
these dtypes: tests/test_torch_small_float_train.py; the backward's plain
version against ml_dtypes' rounding and XLA's reduce order here.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_golden import (
    ASSET,
    FCN_REG_ATOL,
    GOLDEN,
    GOLDEN_F8,
    GOLDEN_MULTI,
    POSE_ATOL,
    asset_configs,
    jax_apply,
    jax_asset_model,
    jax_forward,
    load_npz,
    port_asset_model,
    to_jax_config,
    wrapped_pose_diff,
)
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion_torch import ModelConfig, RangeViewSpec
from tpufusion_torch._golden import (
    F8_E2E_FORMATS,
    F8_E2E_K,
    F8_FRAMES,
    F8_PROB_ATOL,
    FCN_PROB_ATOL,
    small_float_readings,
    small_float_sample,
)
from tpufusion_torch.models import fcn
from tpufusion_torch.ops import parity_inputs
from tpufusion_torch.ops import small_float as sf
from tpufusion_torch.predict import make_e2e_step

NAMES = list(sf.FORMATS)
CROP = 201  # columns of the golden frames the FCN tests run on


def _ml(name: str):
    return getattr(ml_dtypes, name)


def _jax_images(points, valid) -> np.ndarray:
    return np.asarray(jax_project(jnp.asarray(points), to_jax_config(RangeViewSpec()),
                                  jnp.asarray(valid)))


@pytest.fixture(scope="module")
def crop():
    """The golden file's two beam scans as JAX range views, cut to CROP
    columns."""
    with np.load(GOLDEN) as z:
        return _jax_images(z["points"], z["valid"])[:, :, :CROP]


def _port_outputs(model, images):
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(images))
        return model(x).numpy(), model.features(x)


def _codes(features: torch.Tensor, fmt: sf.SmallFloat) -> np.ndarray:
    """A port FCN's features -> the format's codes (uint8)."""
    if features.element_size() == 1:
        return features.view(torch.uint8).numpy()
    return sf.cast(features, fmt, out=torch.uint8).numpy()


def _port(name, images):
    return _port_outputs(port_asset_model(ASSET, name), images)


@pytest.mark.parametrize("name", NAMES)
def test_plain_rounding_matches_ml_dtypes(name):
    """encode / round_small_float against ml_dtypes' casts, code for code:
    every float16 pattern through float16 (`via_f16`), float32 values with
    the formats' edges (`parity_inputs.small_float_inputs`: specials, the
    overflow edge, subnormals, exact ties and their float32 neighbours,
    100k seeded values) directly; every code decodes to ml_dtypes' value."""
    fmt, dt = sf.FORMATS[name], _ml(name)
    patterns, values = parity_inputs.small_float_inputs()
    halves = patterns.view(np.float16)
    with np.errstate(all="ignore"):
        want_h = halves.astype(dt).view(np.uint8)
        want_v = values.astype(dt).view(np.uint8)
    got_h = sf.encode(sf._h(torch.from_numpy(halves.astype(np.float32)), True), fmt)
    np.testing.assert_array_equal(got_h.numpy().astype(np.uint8), want_h)
    np.testing.assert_array_equal(sf.encode(torch.from_numpy(values), fmt).numpy()
                                  .astype(np.uint8), want_v)
    rounded = sf.round_small_float(torch.from_numpy(values), fmt).numpy()
    np.testing.assert_array_equal(rounded, want_v.view(dt).astype(np.float32))
    codes = np.arange(1 << (fmt.ebits + fmt.mbits + fmt.signed), dtype=np.uint8)
    np.testing.assert_array_equal(sf.decode(torch.from_numpy(codes), fmt).numpy(),
                                  codes.view(dt).astype(np.float32))
    assert fmt.carrier == (torch.float32 if name == "float8_e8m0fnu" else torch.float16)


@pytest.mark.parametrize("name", NAMES)
def test_fcn_matches_jax_bit_for_bit(crop, name):
    """The asset's FCN in `name` against JAX's on the golden crop (float16
    convolutions, and float32 ones giving the same bits): the
    regression outputs and the features' codes equal (a NaN where JAX's
    is, with its sign), the probabilities within F8_PROB_ATOL where finite
    and NaN where JAX's are (float8_e8m0fnu has no zero, so its relu is a
    NaN: every output is; float8_e3m4 overflows past 15.5); `features` in
    torch's dtype of the name where torch has one, else float16."""
    fmt = sf.FORMATS[name]
    jm = jax_asset_model(dtype=name)
    want = jax_forward(jm, crop)
    want_codes = np.asarray(jax_apply(jm, lambda m, x: m.features(x), crop)).view(np.uint8)
    got, features = _port(name, crop)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(_codes(features, fmt), want_codes)
    with pytest.MonkeyPatch.context() as mp:  # float32 convolutions: the same bits
        mp.setattr(fcn, "SMALL_FLOAT_CONV", torch.float32)
        got32, features32 = _port(name, crop)
    assert sf.same_bits(torch.from_numpy(got32), torch.from_numpy(got))
    assert sf.same_bits(features32, features)
    np.testing.assert_array_equal(got[..., 2:], want[..., 2:])
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=F8_PROB_ATOL)
    assert features.dtype == (fmt.torch_dtype or torch.float16)
    if name == "float8_e8m0fnu":
        assert np.isnan(want).all() and (want_codes == 0xFF).all()
    elif name != "float8_e3m4":  # its largest value, 15.5, overflows to inf, then NaN
        assert np.isfinite(want).all()


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float8_e4m3b11fnuz",
                                  "float8_e4m3fnuz"])
def test_fcn_without_the_float16_step_differs_from_jax(crop, name, monkeypatch):
    """The negative control: float32 convolutions and an epilogue that
    rounds their result to the format directly, skipping XLA's float16
    step,
    leaves regression outputs off JAX's (14-18 % of them here, by up to
    a unit), so the bit-for-bit test above sees the double rounding.
    float4_e2m1fn is not among them: its sums on these frames fit
    float16's 11 bits, and the step moves nothing."""
    real = sf.conv_epilogue_reference

    def once(y, bias, fmt, relu, out=None):
        return real(sf.round_small_float(y, fmt), bias, fmt, relu, out)

    want = jax_forward(jax_asset_model(dtype=name), crop)
    monkeypatch.setattr(fcn, "SMALL_FLOAT_CONV", torch.float32)  # no float16 convolution
    monkeypatch.setattr(sf, "conv_epilogue_reference", once)
    got, _ = _port(name, crop)
    differ = (got[..., 2:] != want[..., 2:]).mean()
    assert differ > 1e-3, differ


@pytest.fixture(scope="module")
def golden_f8():
    return load_npz(GOLDEN_F8)


@pytest.fixture(scope="module")
def multi():
    gm = load_npz(GOLDEN_MULTI)
    return gm["multi_points"], gm["multi_valid"]


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float4_e2m1fn",
                                  "float8_e8m0fnu"])
def test_port_fcn_matches_the_f8_golden(golden_f8, multi, name):
    """What chip_smoke phase 1g checks on the card, here on the CPU: the
    port's FCN on the golden's full-width frames against its sample of
    JAX's, every feature code equal and the probabilities within
    F8_PROB_ATOL (the card is held to F8_FEATURES_SAME of the codes in
    the first three; float8_e8m0fnu's are all NaN)."""
    points, valid = multi
    from tpufusion_torch.geometry.range_view import range_view_project_batch

    images = range_view_project_batch(torch.from_numpy(points[:F8_FRAMES]), RangeViewSpec(),
                                      torch.from_numpy(valid[:F8_FRAMES])).numpy()
    got, features = _port(name, images)
    same, dp, nan_ok = small_float_readings(
        *small_float_sample(_codes(features, sf.FORMATS[name]), got),
        golden_f8[f"{name}_features"], golden_f8[f"{name}_prob"])
    assert same == 1.0 and dp <= F8_PROB_ATOL and nan_ok, (same, dp, nan_ok)


@pytest.mark.parametrize("name", F8_E2E_FORMATS)
def test_f8_e2e_step_matches_the_golden(golden_f8, multi, name):
    """make_e2e_step(head="direct", top-4) with the asset in `name`
    against JAX's on the multi golden's frames: found equal (what float32
    finds), poses within POSE_ATOL; the FCN's float32 output goes through
    the float32 decode."""
    points, valid = multi
    _, dcfg = asset_configs()
    poses, found = make_e2e_step(port_asset_model(ASSET, name), RangeViewSpec(), dcfg,
                                 max_obstacles=F8_E2E_K, head="direct", device="cpu")(points, valid)
    want_found = golden_f8[f"e2e_{name}_found"]
    np.testing.assert_array_equal(found.numpy(), want_found)
    assert want_found[:, :2].all()
    diff = wrapped_pose_diff(poses.numpy(), golden_f8[f"e2e_{name}_poses"])
    assert float(diff[want_found].max()) <= POSE_ATOL


def test_f8_model_serves_through_the_pipeline_and_the_replay(golden_f8, multi):
    """serve/pipeline.py and serve/replay.py take a float8_e4m3fn model as
    they are: LidarPipeline.predict_position answers JAX's step (the
    golden's first lane), ReplayHarness.run (chunk 2, a padded chunk)
    what make_e2e_step answers on the same clouds."""
    from tpufusion_torch.config import DEFAULT
    from tpufusion_torch.serve.pipeline import LidarPipeline
    from tpufusion_torch.serve.replay import ReplayHarness

    name = "float8_e4m3fn"
    points, valid = multi
    _, dcfg = asset_configs()
    model = port_asset_model(ASSET, name)
    cfg = DEFAULT.replace(model=model.cfg, decode=dcfg)
    pipe = LidarPipeline(cfg=cfg, model=model, max_points=points.shape[1], device="cpu")
    got = [pipe.predict_position(p[v]) for p, v in zip(points, valid)]
    np.testing.assert_array_equal([f for _, f in got], golden_f8[f"e2e_{name}_found"][:, 0])
    diff = wrapped_pose_diff(np.stack([p for p, _ in got]), golden_f8[f"e2e_{name}_poses"][:, 0])
    assert float(diff.max()) <= POSE_ATOL
    clouds = np.where(valid[..., None], points, np.nan).astype(np.float32)
    want_p, want_f = make_e2e_step(model, RangeViewSpec(), dcfg, head="direct",
                                   device="cpu")(clouds)
    poses, found, _ = ReplayHarness(cfg, model, chunk=2, device="cpu").run(clouds)
    np.testing.assert_array_equal(found, want_f.numpy())
    assert found.all() and float(wrapped_pose_diff(poses, want_p.numpy()).max()) <= 1e-5


def test_golden_f8_file_is_current(golden_f8):
    """The f8 golden equals what the JAX package computes now (rerun
    `tests/make_torch_port_golden.py f8` if not): codes and found equal,
    probabilities and poses within 1e-6."""
    from tests.make_torch_port_golden import golden_f8_arrays

    fresh = golden_f8_arrays()
    assert sorted(fresh) == sorted(golden_f8)
    for key, want in fresh.items():
        if want.dtype in (np.uint8, np.bool_):
            np.testing.assert_array_equal(golden_f8[key], want, err_msg=key)
        else:
            np.testing.assert_allclose(golden_f8[key], want, rtol=0, atol=1e-6, err_msg=key)


def _caught(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("name", ["complex64", "complex128"])
def test_complex_names_run_the_float32_net(crop, name):
    """complex64 and complex128 compute the float32 net (JAX's complex net
    has a zero imaginary part: its output is within float32 noise of its
    float32 net, 9.5e-7 here) and return complex64 features; both packages
    warn that the complex output is cast to real, and complex128 that it
    is truncated to complex64 (JAX without x64)."""
    (jm, want, want_feat), jax_warned = _caught(lambda: (
        lambda m: (m, jax_forward(m, crop), jax_apply(m, lambda m, x: m.features(x), crop)))(
            jax_asset_model(dtype=name)))
    port, port_warned = _caught(lambda: port_asset_model(ASSET, name))
    (got, feat), forward_warned = _caught(lambda: _port_outputs(port, crop))
    f32 = port_asset_model(ASSET)
    with torch.inference_mode():
        np.testing.assert_array_equal(got, f32(torch.from_numpy(crop)).numpy())
        feat32 = f32.features(torch.from_numpy(crop))
    assert feat.dtype == torch.complex64 and want_feat.dtype == np.complex64
    assert torch.equal(feat.real, feat32) and not feat.imag.any()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=FCN_PROB_ATOL)
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], rtol=0, atol=FCN_REG_ATOL)
    for warned in (jax_warned, forward_warned):
        assert any(c is DeprecationWarning and "Casting from complex to real" in m
                   for c, m in warned), warned
    truncated = [(jax_warned, "complex128"), (port_warned, "complex128")]
    for warned, word in truncated:
        hit = any(c is UserWarning and word in m and "complex64" in m for c, m in warned)
        assert hit == (name == "complex128"), warned




@pytest.mark.parametrize("name", ["float8_e5m2", "complex64"])
def test_fusion_refuses_small_float_and_complex_fcns(name):
    """JAX's FusionNet refuses a float8 FCN (its features meet float32
    dense layers, a promotion JAX refuses for 8-bit floats): the port's
    raises TypeError at construction. It builds over a complex FCN, into
    complex poses, which JAX's fusion step refuses to differentiate: the
    port's `train_fusion` raises TypeError at its first step
    (tests/test_torch_small_float_train.py holds both nets' outputs and
    trainers to JAX's)."""
    from tpufusion_torch.config import CameraConfig
    from tpufusion_torch.models.fusion import FusionNet
    from tpufusion_torch.train.fusion_trainer import train_fusion

    cfg = dataclasses.replace(ModelConfig(), dtype=name)
    if name.startswith("float8"):
        with pytest.raises(TypeError, match="promotion"):
            FusionNet(lidar_model=cfg)
        return
    camera = CameraConfig(width=136, height=64)
    net = FusionNet(lidar_model=cfg, camera=camera, lidar_pool=(2, 8), cam_pool=(8, 8))
    rng = np.random.default_rng(0)
    data = {"cam": rng.random((2, 64, 136, 1), dtype=np.float32),
            "lidar": rng.random((2, 32, 1801, 3), dtype=np.float32),
            "radar": rng.random((2, 2), dtype=np.float32),
            "centroid": np.zeros((2, 3), np.float32), "rz": np.zeros((2, 1), np.float32)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(TypeError, match="real-valued outputs"):
            train_fusion(net, data, epochs=1, batch_size=2, device="cpu")


def test_wrappers_run_the_plain_version_on_the_cpu_and_refuse_other_devices():
    """On the CPU both wrappers are their plain versions and launch
    nothing; a tensor on another device raises."""
    fmt = sf.FORMATS["float8_e4m3fn"]
    y = torch.linspace(-500, 500, 2 * 3 * 4 * 5).view(2, 3, 4, 5)
    b = torch.tensor([0.3, -0.7, 1e-4])
    before = sf.LAUNCHES
    for relu in (False, True):
        torch.testing.assert_close(sf.conv_epilogue(y, b, fmt, relu),
                                   sf.conv_epilogue_reference(y, b, fmt, relu), rtol=0, atol=0,
                                   equal_nan=True)
    assert sf.same_bits(sf.cast(y, fmt, out=torch.uint8), sf.cast_reference(y, fmt,
                                                                            out=torch.uint8))
    assert sf.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sf.cast(y.to("meta"), fmt)
    with pytest.raises(ValueError, match="cannot be written"):
        sf.cast(y, sf.FORMATS["float8_e8m0fnu"], out=torch.float16)


# -- the backward's plain version ---------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_add_table_is_ml_dtypes_sum_through_float16(name):
    """`add_table`: every pair of the format's codes summed in float32,
    rounded to float16 where the format goes through it, then to the
    format, as ml_dtypes casts: XLA's add of two format values."""
    fmt, dt = sf.FORMATS[name], _ml(name)
    n = 1 << (fmt.ebits + fmt.mbits + fmt.signed)
    vals = np.arange(n, dtype=np.uint8).view(dt).astype(np.float32)
    with np.errstate(all="ignore"):
        total = vals[:, None] + vals[None, :]
        if fmt.via_f16:
            total = total.astype(np.float16)
        want = total.astype(dt).view(np.uint8)
    got = sf.add_table(fmt).numpy().astype(np.uint8)
    nan = np.isnan(want.view(dt).astype(np.float32))
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(sf.decode(torch.from_numpy(got[nan]), fmt).numpy()).all()


def _hlo_windows(shape, dtype=jnp.float16):
    """The reduce-windows XLA's CPU compiles a sum over the first three
    axes of `shape` + (2,) into: [(window sizes, low paddings)] in order."""
    import re

    text = jax.jit(lambda x: jnp.sum(x, axis=(0, 1, 2))).lower(
        jax.ShapeDtypeStruct(tuple(shape) + (2,), dtype)).compile().as_text()
    found = []
    for m in re.finditer(r"reduce-window\([^)]*\), window=\{size=([0-9x]+) stride=[0-9x]+"
                         r"(?: pad=([0-9_x]+))?", text):
        sizes = tuple(int(v) for v in m.group(1).split("x"))[:3]
        pads = tuple(int(p.split("_")[0]) for p in m.group(2).split("x"))[:3] if m.group(2) \
            else (0, 0, 0)
        found.append((sizes, pads))
    return found


@pytest.mark.parametrize("dims", [(2, 8, 61), (2, 32, 451), (2, 32, 1804), (33, 3, 40),
                                  (1, 1, 1100), (2, 8, 16)])
def test_xla_sum_levels_are_the_windows_xla_compiles(dims):
    """`xla_sum_levels` against the reduce-windows in XLA's optimized HLO
    of a float16 sum over (B, H, W) on the CPU (TreeReductionRewriter):
    each level's windows and low paddings, and none where every dimension
    is at most 32."""
    levels = sf.xla_sum_levels(dims)
    want = [(tuple(w for w, _, _ in lv), tuple(lo for _, _, lo in lv)) for lv in levels[:-1]]
    assert _hlo_windows(dims) == want


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2", "float4_e2m1fn",
                                  "float8_e4m3fnuz", "float8_e8m0fnu"])
@pytest.mark.parametrize("shape", parity_inputs.SMALL_FLOAT_BACKWARD_SHAPES)
def test_bias_grad_reference_is_jaxs_sum_in_the_format(name, shape):
    """`bias_grad_reference` on (B, C, H, W) format values against
    jnp.sum over batch, height and width of the same values (NHWC) in the
    format, then float32: the bias gradient's reduce in XLA, every partial
    sum rounded to the format, in its windowed order (bit for bit, NaN
    where JAX's)."""
    fmt, dt = sf.FORMATS[name], _ml(name)
    arrays = parity_inputs.small_float_backward_inputs(shape, seed=5)
    for key in ("small", "typical"):
        g = arrays[key]
        if not fmt.signed:
            g = np.abs(g)
        g = g.astype(dt)
        want = np.asarray(jax.jit(lambda x: jnp.sum(x, axis=(0, 1, 2)).astype(jnp.float32))(
            jnp.asarray(g.transpose(0, 2, 3, 1))))
        got = sf.bias_grad_reference(torch.from_numpy(g.astype(np.float32)), fmt).numpy()
        assert np.array_equal(got, want, equal_nan=True), (key, got, want)


def test_backward_reference_rounds_each_sum_and_selects_relu():
    """The backward's plain version, element by element: each cotangent
    rounded through float16 to the format, each sum rounded, relu's
    select on the forward's value (> 0), fmt(0) elsewhere; float8_e8m0fnu
    selects its NaN; the carrier or float32 out; the no-bias mode is the
    rounding alone."""
    fmt = sf.FORMATS["float8_e4m3fn"]
    g1 = torch.tensor([0.30, 0.0, 100.0, -2.1, 1e-3]).view(1, 1, 1, 5)
    g2 = torch.tensor([0.26, 0.5, 300.0, 2.0, 1e-3]).view(1, 1, 1, 5)
    saved = torch.tensor([1.0, 1.0, 1.0, 0.0, float("nan")]).view(1, 1, 1, 5)
    got, gb = sf.conv_epilogue_backward_reference([g1, g2], saved, fmt, True, torch.float32)

    def r(v):
        return float(sf.round_small_float(torch.tensor(v), fmt, True))

    want = [r(r(0.30) + r(0.26)), r(0.5), r(r(100.0) + r(300.0)), 0.0, 0.0]
    assert got.view(-1).tolist() == want and want[2] == 384.0
    acc = 0.0
    for v in want:
        acc = r(acc + v)
    assert gb.shape == (1,) and float(gb) == acc
    e8 = sf.FORMATS["float8_e8m0fnu"]
    out, gb = sf.conv_epilogue_backward_reference([g1.abs() + 1], torch.zeros_like(g1), e8, True)
    assert out.dtype == torch.float32 and torch.isnan(out).all() and torch.isnan(gb).all()
    assert sf.same_bits(sf.round_grad(g1, fmt), sf.round_small_float(g1, fmt, True).half())
