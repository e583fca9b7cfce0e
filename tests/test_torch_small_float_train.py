"""Training in the small-float and complex configurations against JAX, on
the CPU.

The shipped asset's FCN geometry (direct head, width 2) with seeded numpy
weights (`random_arrays`) on the golden file's two beam scans cut to CROP
columns, a foreground box and regression targets of numpy's seed, and
LossConfig(weight_bb=1) (the asset's training weight, which gives the
regression branch gradients the formats can hold): the loss and every
parameter's gradient of `nnx.value_and_grad` against the port's autograd.
In each of the nine small-float names every gradient of a convolution
(kernel and bias) equals JAX's bit for bit, NaN where JAX's is
(float8_e8m0fnu: everywhere; float8_e3m4 overflows past 15.5), and the
input norm's float32 gradients lie within NORM_GRAD_RTOL of their largest
entry; the loss within LOSS_RTOL. Without the rounding of the summed
cotangents at the fan-out points (c1, c2, cat4), or without the rounding
of a dgrad before it is summed, the gradients differ from JAX's (the
negative controls). complex64 and complex128 train the float32 net: the
same gradients as the port's float32 net, within GRAD_RTOL of JAX's
complex ones, with JAX's warnings. `Trainer.fit` in float8_e4m3fn and
float8_e5m2 against JAX's `make_train_step` with optax's Adam (the
parameters within PARAM_ATOL after STEPS steps); float8_e8m0fnu's NaN
loss through both trainers' divergence handling (abort with no
checkpoint, restore with one); a mesh of one runs the float8_e4m3fn step
bit for bit the plain step. The f8 gradient golden
(`tests/data/torch_port_golden_f8_grad.npz`, the card's reference)
against JAX run here in two formats, and against the port's first step
at full width. `FusionNet` with a complex FCN against JAX's (complex64
outputs, a zero imaginary part), `predict_fusion` on it, and
`train_fusion` raising TypeError at its first step as JAX's does.
"""

import dataclasses
import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from tests.torch_golden import (
    ASSET,
    GOLDEN,
    GOLDEN_F8_GRAD,
    asset_configs,
    jax_apply,
    jax_model_from_arrays,
    jax_module_from_arrays,
    load_npz,
    random_arrays,
    to_jax_config,
)
from tpufusion import config as jax_config
from tpufusion.geometry.range_view import range_view_project_batch as jax_project
from tpufusion.models import fusion as jax_fusion
from tpufusion.models.losses import weighted_pose_loss as jax_loss
from tpufusion.train import fusion_trainer as jax_fusion_trainer
from tpufusion.train import train_step as jax_train_step
from tpufusion.train import trainer as jax_trainer
from tpufusion_torch import RangeViewSpec
from tpufusion_torch._golden import F8_GRAD_LOSS, F8_GRAD_NORM_RTOL, format_steps
from tpufusion_torch.config import (
    CameraConfig,
    LossConfig,
    ModelConfig,
    PipelineConfig,
    TrainConfig,
)
from tpufusion_torch.data.synthetic import synthesize_beam_scan_batch
from tpufusion_torch.models import fusion as port_fusion
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.losses import weighted_pose_loss
from tpufusion_torch.ops import small_float as sf
from tpufusion_torch.serve import fusion as port_serve
from tpufusion_torch.train import fusion_trainer as port_fusion_trainer
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.train_step import make_train_step
from tpufusion_torch.train.trainer import Trainer

NAMES = list(sf.FORMATS)
CROP = 201  # columns of the golden frames
LOSS = LossConfig(weight_bb=1.0)
LOSS_RTOL = 1e-5  # the loss is a float32 sum in another order (reads 1e-7)
NORM_GRAD_RTOL = F8_GRAD_NORM_RTOL  # the norm's float32 gradients (read 1e-6)
NORM_LOSS_RTOL = 1e-3  # with the norm: its inputs' flips move the loss (reads 1e-4)
GRAD_DIFFER = 0.03  # with the norm: a convolution's gradient values off JAX's (read 1.7 %)
GRAD_STEPS = 4  # ... and by at most this many steps of the format (read 3)
# with the norm: its float32 gradients sum the input's cotangent, whose
# values a flip moves by a step of the format (read 1.1e-3)
NORM_FLIP_RTOL = 1e-2
GRAD_RTOL = 1e-4  # complex vs float32 nets, float32 gradients (read 5e-10)
PARAM_ATOL = 1e-6
STEPS = 3
SMALL = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
WEIGHTS_SEED = 3
SMALL_CAMERA = CameraConfig(width=136, height=64)


def _mcfg(name: str, norm: bool = True) -> ModelConfig:
    """The asset's geometry in `name`; without `norm`, no input norm."""
    return dataclasses.replace(asset_configs()[0], dtype=name, batch_norm=norm)


@pytest.fixture(scope="module")
def arrays():
    return random_arrays(FCN(_mcfg("float32")), WEIGHTS_SEED)


@pytest.fixture(scope="module")
def batch():
    """(images (2, 32, CROP, 3), labels (2, 32, CROP, 10)): the golden
    file's beam scans as JAX range views, a foreground box at rows 13-18,
    columns 60-89, regression targets U(-1, 1) on it."""
    with np.load(GOLDEN) as z:
        images = np.asarray(jax_project(jnp.asarray(z["points"]),
                                        to_jax_config(RangeViewSpec()),
                                        jnp.asarray(z["valid"])))[:, :, :CROP]
    rng = np.random.default_rng(7)
    fg = np.zeros(images.shape[:3], bool)
    fg[:, 13:19, 60:90] = True
    reg = rng.uniform(-1, 1, images.shape[:3] + (8,)) * fg[..., None]
    labels = np.concatenate([np.eye(2)[fg.astype(int)], reg], -1).astype(np.float32)
    return np.ascontiguousarray(images), labels


_JAX_GRADS: dict = {}


def _jax_grads(name, arrays, images, labels, norm=True):
    """JAX's (loss, {"<layer>/<param>": gradient}) of the FCN in `name`
    (cached: the negative controls reuse them)."""
    if (name, norm) not in _JAX_GRADS:
        graphdef, state = nnx.split(jax_model_from_arrays(_mcfg(name, norm), _arrays(arrays, norm)))
        jloss = to_jax_config(LOSS)

        def value_and_grad(state, x, y):
            model = nnx.merge(graphdef, state)
            return nnx.value_and_grad(lambda m: jax_loss(m(x, train=True), y, jloss))(model)

        loss, grads = jax.jit(value_and_grad)(state, images, labels)
        _JAX_GRADS[name, norm] = float(loss), {"/".join(map(str, k)): np.asarray(g)
                                               for k, g in nnx.to_flat_state(grads)}
    return _JAX_GRADS[name, norm]


def _arrays(arrays, norm):
    return arrays if norm else {k: v for k, v in arrays.items() if not k.startswith("norm/")}


def _port_grads(name, arrays, images, labels, norm=True):
    model = FCN(_mcfg(name, norm))
    models_io.load_arrays(model, _arrays(arrays, norm))
    loss = weighted_pose_loss(model(torch.from_numpy(images), train=True),
                              torch.from_numpy(labels), LOSS)
    loss.backward()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return float(loss), {k.replace(".", "/"): p.grad.numpy() for k, p in model.named_parameters()}


def _same(got, want) -> bool:
    """Equal values, NaN where the other is NaN (a NaN's sign not
    compared: XLA's and torch's NaNs of a float32 sum differ)."""
    return got.shape == want.shape and bool(np.all((got == want) | (np.isnan(got)
                                                                     & np.isnan(want))))


def _norm_close(got, want, rtol=NORM_GRAD_RTOL) -> bool:
    """Within rtol of the largest entry, NaN where the other is."""
    if np.isnan(want).any():
        return bool(np.array_equal(np.isnan(got), np.isnan(want)))
    return float(np.abs(got - want).max()) <= rtol * max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_gradients_without_the_norm_match_jax_bit_for_bit(arrays, batch, name):
    """The asset's geometry without its input norm: every convolution's
    kernel and bias gradient equals JAX's bit for bit (NaN where JAX's
    is), the loss within LOSS_RTOL; the parameters and their gradients
    stay float32."""
    want_loss, want = _jax_grads(name, arrays, *batch, norm=False)
    got_loss, got = _port_grads(name, arrays, *batch, norm=False)
    assert sorted(got) == sorted(want)
    if np.isnan(want_loss):
        assert np.isnan(got_loss)
    else:
        assert abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for k in want:
        assert got[k].dtype == np.float32 and _same(got[k], want[k]), (k, np.mean(got[k] ==
                                                                                  want[k]))
    if name == "float8_e8m0fnu":  # no zero: every relu, and so every gradient, is a NaN
        assert all(np.isnan(g).all() for g in want.values())
    elif name in ("float8_e4m3fn", "float8_e5m2", "float4_e2m1fn"):  # float8_e3m4 and
        # float8_e4m3b11fnuz overflow past 15.5 and 30 on these inputs
        assert all(np.isfinite(g).all() for g in want.values())


@pytest.mark.parametrize("name", NAMES)
def test_gradients_with_the_norm_match_jax(arrays, batch, name):
    """The asset's own geometry, its input norm on the batch's statistics
    (train=True): JAX sums them in float32 in XLA's windowed order, torch
    in its own, a few ulps apart; where a normalised input lies at a
    midpoint of the format its cast rounds the other way, and the forward
    and the gradients carry that on (float8_e4m3b11fnuz: 217 of 128,640
    outputs, 0.5 % of the kernels' gradients; a dgrad's or wgrad's
    float32 sum at a midpoint does it too: float8_e4m3fn, one of conv1's
    600). So each convolution's gradient is held to GRAD_DIFFER of its
    values off JAX's (at least one), none more than GRAD_STEPS steps of
    the format, NaN where JAX's is; the input norm's within
    NORM_FLIP_RTOL; the loss within NORM_LOSS_RTOL. The regression branch
    carries gradients in some format (its fan-outs' three-way sums)."""
    fmt = sf.FORMATS[name]
    want_loss, want = _jax_grads(name, arrays, *batch)
    got_loss, got = _port_grads(name, arrays, *batch)
    assert sorted(got) == sorted(want)
    if np.isnan(want_loss):
        assert np.isnan(got_loss)
    else:
        assert abs(got_loss - want_loss) <= NORM_LOSS_RTOL * abs(want_loss)
    for k in want:
        assert got[k].dtype == np.float32
        if k.startswith("norm/"):
            assert _norm_close(got[k], want[k], NORM_FLIP_RTOL), k
            continue
        steps = format_steps(got[k], want[k], fmt)
        assert int((steps > 0).sum()) <= max(1, GRAD_DIFFER * steps.size), (k, steps.sum())
        assert int(steps.max()) <= GRAD_STEPS, k
    if name == "float8_e5m2":
        assert all(np.abs(want[f"deconv{i}b/kernel"]).max() > 0 for i in (5, 6))


def test_float16_backward_convolutions_are_not_one_rounding():
    """Why `fcn._GradConv` runs a small-float net's dgrad and wgrad in
    float32: XLA computes them in float32 and rounds the result to
    float16 once, and torch's float16 convolution backward on the CPU
    gives other values (seeded float16 operands of a 5 x 5 layer: 90 of
    69,120 dgrad values at any thread count, 16 of 3,200 wgrad values on
    two threads, which split its sum)."""
    rng = np.random.default_rng(0)
    x, w, g = (torch.from_numpy(rng.normal(0, s, shape).astype(np.float16)) for s, shape in
               ((4, (2, 16, 36, 60)), (0.1, (8, 16, 5, 5)), (1, (2, 8, 32, 56))))

    def grads(dt):
        return torch.ops.aten.convolution_backward(
            g.to(dt), x.to(dt), w.to(dt), None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1,
            [True, True, False])[:2]

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for half, full in zip(grads(torch.float16), grads(torch.float32)):
            assert bool((half != full.half()).any())
    finally:
        torch.set_num_threads(threads)


def _fold_once(real):
    """The backward without the rounding at the fan-out points: each
    cotangent rounded, their sum rounded once."""
    def backward(grads, saved, fmt, relu, out=None, bias=True):
        if len(grads) > 1:
            total = sum(sf.round_small_float(g, fmt, fmt.via_f16) for g in grads)
            grads = [total]
        return real(grads, saved, fmt, relu, out, bias)
    return backward


def _raw_sum(real):
    """The backward without the rounding of a dgrad before the sum: the
    raw cotangents summed, the sum rounded."""
    def backward(grads, saved, fmt, relu, out=None, bias=True):
        if len(grads) > 1:
            grads = [sum(sf._f32(g) for g in grads)]
        return real(grads, saved, fmt, relu, out, bias)
    return backward


@pytest.mark.parametrize("fault", ["fan-out", "dgrad"])
def test_without_the_rounding_of_summed_cotangents_gradients_differ(arrays, batch, fault,
                                                                    monkeypatch):
    """The negative controls, float8_e5m2 (whose range keeps the
    regression branch's cotangents) without the input norm, where the
    port is held to JAX bit for bit: the unfaulted backward equals JAX's
    in every gradient; summing the fan-outs' cotangents without rounding
    each sum, or summing the dgrads before rounding them, leaves some
    convolution's gradient off JAX's."""
    name = "float8_e5m2"
    _, want = _jax_grads(name, arrays, *batch, norm=False)
    _, clean = _port_grads(name, arrays, *batch, norm=False)
    assert all(_same(clean[k], want[k]) for k in want)
    fake = {"fan-out": _fold_once, "dgrad": _raw_sum}[fault]
    monkeypatch.setattr(sf, "conv_epilogue_backward_reference",
                        fake(sf.conv_epilogue_backward_reference))
    _, got = _port_grads(name, arrays, *batch, norm=False)
    differ = [k for k in want if not _same(got[k], want[k])]
    assert differ, fault


@pytest.mark.parametrize("name", ["complex64", "complex128"])
def test_complex_trains_the_float32_net_with_jaxs_warnings(arrays, batch, name):
    """complex64 and complex128 give the port's float32 net's loss and
    gradients bit for bit and JAX's complex ones within GRAD_RTOL (JAX's
    complex net lies 5e-10 from its float32 net); both forwards warn
    "Casting from complex to real" once a cast (d6a and d6b), complex128
    also that it is truncated to complex64."""
    with warnings.catch_warnings(record=True) as jax_warned:
        warnings.simplefilter("always")
        want_loss, want = _jax_grads(name, arrays, *batch)
    with warnings.catch_warnings(record=True) as port_warned:
        warnings.simplefilter("always")
        got_loss, got = _port_grads(name, arrays, *batch)
    f32_loss, f32 = _port_grads("float32", arrays, *batch)
    assert got_loss == f32_loss and abs(got_loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for k in want:
        assert np.array_equal(got[k], f32[k]), k
        tol = GRAD_RTOL * max(float(np.abs(want[k]).max()), 1e-30)
        assert float(np.abs(got[k] - want[k]).max()) <= tol, k

    def casts(warned):
        return sum(w.category is DeprecationWarning and "Casting from complex to real"
                   in str(w.message) for w in warned)

    def truncated(warned):
        return any("complex128" in str(w.message) and "complex64" in str(w.message)
                   for w in warned if w.category is UserWarning)

    assert casts(port_warned) == casts(jax_warned) == 2
    assert truncated(port_warned) == truncated(jax_warned) == (name == "complex128")


class _Batches:
    """A fixed list of batches, one epoch each pass (`Trainer.fit`'s
    pipeline interface)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self):
        return iter(self.batches)


def _scene_batches(n=STEPS, b=2, seed=40):
    out = []
    for i in range(n):
        pts, gt, valid = synthesize_beam_scan_batch(np.random.default_rng(seed + i), b, 2048)
        out.append({"points": pts, "valid": valid, **{k: gt[k] for k in ("center", "size",
                                                                          "yaw")}})
    return out


def _trainer_cfg(name, **train):
    mcfg, dcfg = asset_configs()
    return PipelineConfig(
        range_view=SMALL, model=dataclasses.replace(mcfg, dtype=name), decode=dcfg, loss=LOSS,
        train=TrainConfig(**{"batch_size": 2, "epochs": 1, "learning_rate": 3e-3,
                             "augment": False, "divergence_check_every": 1, **train}))


def _jax_trainer_pieces(cfg, arrays):
    jmodel = jax_model_from_arrays(cfg.model, arrays)
    jopt = nnx.Optimizer(jmodel, optax.adam(cfg.train.learning_rate), wrt=nnx.Param)
    jstep = jax_train_step.make_train_step(
        to_jax_config(cfg.range_view), to_jax_config(cfg.loss), to_jax_config(cfg.train),
        head="direct", yaw_frame=cfg.decode.direct_yaw_frame)
    return jmodel, jopt, jstep


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_trainer_fit_matches_jaxs_steps_with_adam(arrays, tmp_path, name):
    """`Trainer.fit` (one epoch of STEPS beam-scan batches at 32 x 201)
    against JAX's `make_train_step` with optax's Adam from the same
    weights on the same batches: the step losses within LOSS_RTOL, every
    parameter within PARAM_ATOL, still float32, and a checkpoint that
    `resume` restores."""
    cfg = _trainer_cfg(name)
    batches = _scene_batches()
    model = FCN(cfg.model)
    models_io.load_arrays(model, arrays)
    trainer = Trainer(cfg, model=model, outdir=str(tmp_path / "run"), device="cpu")
    hist = trainer.fit(_Batches([{k: torch.from_numpy(v) for k, v in b.items()}
                                 for b in batches]))
    jmodel, jopt, jstep = _jax_trainer_pieces(cfg, arrays)
    key = jax.random.PRNGKey(0)
    want_losses = []
    for b in batches:
        key, sub = jax.random.split(key)
        loss, _ = jstep(jmodel, jopt, {k: jnp.asarray(v) for k, v in b.items()}, sub)
        want_losses.append(float(loss))
    np.testing.assert_allclose(hist.batch["loss"], want_losses, rtol=LOSS_RTOL)
    want = {"/".join(map(str, k)): np.asarray(v)
            for k, v in nnx.to_flat_state(nnx.state(jmodel, nnx.Param))}
    for k, p in trainer.model.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), want[k.replace(".", "/")], rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
    assert trainer.ckpt.latest_step() == STEPS
    fresh = Trainer(cfg, outdir=str(tmp_path / "run"), device="cpu")
    assert fresh.resume() and fresh.step == STEPS
    for a, b in zip(fresh.model.parameters(), trainer.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("checkpoint", [False, True])
def test_e8m0_divergence_is_handled_as_jaxs_trainer_handles_it(arrays, tmp_path, checkpoint):
    """float8_e8m0fnu's loss is a NaN at the first step: without a
    checkpoint both trainers abort and write none (the weights are NaN),
    with one (step 0) both restore it and end on its weights; the
    histories, steps and checkpoints agree."""
    cfg = _trainer_cfg("float8_e8m0fnu")
    batches = _scene_batches(2)
    model = FCN(cfg.model)
    models_io.load_arrays(model, arrays)
    trainer = Trainer(cfg, model=model, outdir=str(tmp_path / "port"), device="cpu")
    jtrainer = jax_trainer.Trainer(to_jax_config(cfg), model=jax_model_from_arrays(
        cfg.model, arrays), outdir=str(tmp_path / "jax"))
    if checkpoint:
        trainer.ckpt.save(0, trainer.model, trainer.optimizer)
        jtrainer.ckpt.save(0, jtrainer.model, jtrainer.optimizer)
    before = {k: p.detach().clone() for k, p in trainer.model.named_parameters()}
    with _quiet_logs():
        hist = trainer.fit(_Batches([{k: torch.from_numpy(v) for k, v in b.items()}
                                     for b in batches]))
        jhist = jtrainer.fit(_Batches([{k: jnp.asarray(v) for k, v in b.items()}
                                       for b in batches]))
    assert hist.batch == jhist.batch and hist.epoch["loss"] == jhist.epoch["loss"] == []
    assert trainer.step == jtrainer.step
    assert trainer.ckpt.latest_step() == jtrainer.ckpt.latest_step() == (0 if checkpoint
                                                                         else None)
    assert trainer._params_finite() == jtrainer._params_finite() == checkpoint
    if checkpoint:
        for k, p in trainer.model.named_parameters():
            assert torch.equal(p.detach(), before[k]), k


class _quiet_logs:
    def __enter__(self):
        self.level = logging.root.manager.disable
        logging.disable(logging.ERROR)

    def __exit__(self, *exc):
        logging.disable(self.level)


def test_mesh_of_one_runs_the_f8_step_bit_for_bit(arrays):
    """A data-parallel mesh of one (gloo on the CPU): two float8_e4m3fn
    steps give the plain step's losses, gradients, parameters and
    BatchNorm statistics bit for bit."""
    import torch.distributed as dist

    from tpufusion_torch.config import MeshConfig
    from tpufusion_torch.parallel.mesh import make_mesh

    cfg = _trainer_cfg("float8_e4m3fn")
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in _scene_batches(2)]
    mesh = make_mesh(MeshConfig(n_devices=1), device="cpu")
    try:
        outs = []
        for m in (None, mesh):
            model = FCN(cfg.model)
            models_io.load_arrays(model, arrays)
            opt = Adam(model.parameters(), 3e-3)
            step = make_train_step(SMALL, LOSS, cfg.train, mesh=m, head="direct",
                                   yaw_frame=cfg.decode.direct_yaw_frame, device="cpu")
            losses = [step(model, opt, b)[0] for b in batches]
            outs.append({**{f"loss{i}": v for i, v in enumerate(losses)},
                         **{f"grad/{n}": p.grad for n, p in model.named_parameters()},
                         **{f"param/{n}": p.detach() for n, p in model.named_parameters()},
                         **{f"buffer/{n}": b for n, b in model.named_buffers()}})
        plain, meshed = outs
        assert sorted(plain) == sorted(meshed)
        assert [k for k in plain if not torch.equal(plain[k], meshed[k])] == []
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def golden_f8_grad():
    return load_npz(GOLDEN_F8_GRAD)


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
def test_golden_f8_grad_file_is_current(golden_f8_grad, name):
    """The f8 gradient golden's inputs and its `name` part equal what the
    JAX package computes now (rerun `tests/make_torch_port_golden.py
    f8_grad` if not): the inputs and gradients equal, the loss within
    1e-6."""
    from tests.make_torch_port_golden import golden_f8_grad_arrays

    fresh = golden_f8_grad_arrays([name])
    want = {k: v for k, v in golden_f8_grad.items() if "/" not in k or k.startswith(name + "/")}
    assert sorted(fresh) == sorted(want)
    for k, v in fresh.items():
        if k.endswith("/loss"):
            np.testing.assert_allclose(want[k], v, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert _same(np.asarray(want[k]), np.asarray(v)), k


@pytest.mark.parametrize("name", ["float8_e4m3fn", "float4_e2m1fn", "float8_e8m0fnu"])
def test_port_step_at_full_width_matches_the_f8_grad_golden(golden_f8_grad, name):
    """What chip_smoke phase 1h holds the card to, here on the CPU: the
    port's train step with the asset in `name` on the golden's two beam
    scans at 32 x 1801 gives JAX's gradients, every convolution's bit for
    bit, the input norm's within F8_GRAD_NORM_RTOL, the loss within
    LOSS_RTOL."""
    mcfg, dcfg = asset_configs()
    model = FCN(dataclasses.replace(mcfg, dtype=name))
    models_io.load_state_npz(ASSET, model)
    step = make_train_step(RangeViewSpec(), LossConfig(**F8_GRAD_LOSS), TrainConfig(augment=False),
                           head="direct", yaw_frame=dcfg.direct_yaw_frame, device="cpu")
    batch = {k: torch.from_numpy(np.array(golden_f8_grad[k]))
             for k in ("points", "valid", "center", "size", "yaw")}
    loss, _ = step(model, Adam(model.parameters(), 1e-3), batch)
    want_loss = float(golden_f8_grad[f"{name}/loss"])
    assert (np.isnan(want_loss) and np.isnan(float(loss))) or (
        abs(float(loss) - want_loss) <= LOSS_RTOL * abs(want_loss))
    for k, p in model.named_parameters():
        want = golden_f8_grad[f"{name}/{k.replace('.', '/')}"]
        got = p.grad.numpy()
        assert (_norm_close(got, want) if k.startswith("norm.") else _same(got, want)), k


# -- the fusion net with a complex FCN --------------------------------------------

def _jax_fusion_build(lidar_dtype, camera_dtype):
    def build():
        return jax_fusion.FusionNet(
            lidar_model=jax_config.ModelConfig(dtype=lidar_dtype),
            camera_model=jax_config.ModelConfig(vertical_stride=2, use_regression=False,
                                                dtype=camera_dtype),
            camera=jax_config.CameraConfig(width=SMALL_CAMERA.width,
                                           height=SMALL_CAMERA.height),
            lidar_pool=(2, 8), cam_pool=(8, 8), rngs=nnx.Rngs(2))
    return build


def _port_fusion_net(lidar_dtype, camera_dtype):
    return port_fusion.FusionNet(
        lidar_model=ModelConfig(dtype=lidar_dtype),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype=camera_dtype),
        camera=SMALL_CAMERA, lidar_pool=(2, 8), cam_pool=(8, 8))


def _fusion_data(seed=8, n=3):
    rng = np.random.default_rng(seed)
    pts, _, valid = synthesize_beam_scan_batch(rng, n, 4096)
    lidar = np.asarray(jax_project(jnp.asarray(pts), jax_config.RangeViewSpec(),
                                   jnp.asarray(valid)))
    cam = rng.uniform(0, 1, (n, SMALL_CAMERA.height, SMALL_CAMERA.width, 1)).astype(np.float32)
    radar = np.stack([rng.uniform(5, 30, n), rng.uniform(-0.4, 0.4, n)], -1).astype(np.float32)
    poses = rng.uniform(-10, 10, (n, 4)).astype(np.float32)
    return {"cam": cam, "lidar": lidar, "radar": radar, "centroid": poses[:, :3],
            "rz": poses[:, 3:]}


def _fusion_pair(lidar_dtype, camera_dtype, seed=6):
    net = _port_fusion_net(lidar_dtype, camera_dtype)
    arrays = random_arrays(net, seed)
    models_io.load_arrays(net, arrays)
    jnet = jax_module_from_arrays(_jax_fusion_build(lidar_dtype, camera_dtype), arrays)
    return net.eval(), jnet


@pytest.mark.parametrize("lidar_dtype,camera_dtype", [("complex64", "float32"),
                                                      ("float32", "complex64"),
                                                      ("complex128", "complex64")])
def test_fusion_net_with_a_complex_fcn_matches_jax(lidar_dtype, camera_dtype):
    """FusionNet over a complex FCN returns complex64 centroid and rz as
    JAX's does, their imaginary parts zero in both (JAX keeps them exactly
    zero through the max-pools, the dense layers, relu and elu), the real
    parts within 1e-4 of JAX's and equal to the port's float32 net's."""
    net, jnet = _fusion_pair(lidar_dtype, camera_dtype)
    d = _fusion_data()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax_apply(jnet, lambda m, c, l, r: m(c, l, r, train=False), d["cam"],
                         d["lidar"], d["radar"])
        with torch.inference_mode():
            got = net(*(torch.from_numpy(d[k]) for k in ("cam", "lidar", "radar")))
    f32, _ = _fusion_pair("float32", "float32")
    with torch.inference_mode():
        real = f32(*(torch.from_numpy(d[k]) for k in ("cam", "lidar", "radar")))
    for g, w, r in zip(got, want, real):
        w = np.asarray(w)
        assert g.dtype == torch.complex64 and w.dtype == np.complex64 and g.shape == w.shape
        assert not g.imag.any() and not np.any(w.imag)
        assert torch.equal(g.real, r)
        np.testing.assert_allclose(g.real.numpy(), w.real, rtol=0, atol=1e-4)


def test_predict_fusion_with_a_complex_fcn_writes_jaxs_csv(tmp_path):
    """predict_fusion on a net with a complex64 lidar FCN: the CSV's rows
    within 1e-4 of JAX's (both cast the complex values to their real
    part)."""
    import csv

    net, jnet = _fusion_pair("complex64", "float32")
    d = _fusion_data(n=3)
    ts = [10, 20, 30]
    jcsv, pcsv = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jax_fusion_trainer.predict_fusion(jnet, d, ts, jcsv, batch_size=2)
        port_serve.predict_fusion(net, d, ts, pcsv, batch_size=2, device="cpu")
    rows = []
    for path in (jcsv, pcsv):
        with open(path) as f:
            rows.append(list(csv.DictReader(f)))
    assert len(rows[0]) == len(rows[1]) == 3
    for w, g in zip(*rows):
        assert g["timestamp"] == w["timestamp"]
        for k in ("tx", "ty", "tz", "rz"):
            assert abs(float(g[k]) - float(w[k])) <= 1e-4, (k, g[k], w[k])


def test_train_fusion_with_a_complex_fcn_raises_type_error_as_jax():
    """JAX's fusion step refuses a complex FCN's net at its first step
    (grad requires real-valued outputs): both trainers raise TypeError."""
    net, jnet = _fusion_pair("complex64", "float32")
    d = _fusion_data(n=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(TypeError, match="real-valued outputs"):
            jax_fusion_trainer.train_fusion(jnet, d, epochs=1, batch_size=2)
        with pytest.raises(TypeError, match="real-valued outputs"):
            port_fusion_trainer.train_fusion(net, d, epochs=1, batch_size=2, device="cpu")
