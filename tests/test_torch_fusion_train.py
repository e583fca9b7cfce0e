"""The port's fusion training against the JAX package, on the CPU.

A small FusionNet (camera 64 x 93 x 1, lidar 32 x 201 x 3, pools (2, 8) /
(8, 8): widths whose convolutions round-trip) holds the same numpy weights
in both packages and sees the same numpy inputs. The reference's dropout
draws from `jax.random` and cannot match bit for bit, so wherever the two
are compared the rates are 0 on both sides (set on the test's own JAX
object); the port's dropout is checked by its keep share, its 1 / 0.8
scale and its determinism under one generator seed.

Tolerances: outputs and loss 1e-5 relative; float32 gradients 1e-4 of
each tensor's largest entry; bf16 kernels 2**-6 (they read 3.2e-3), bf16
conv biases 2**-2 against the nearer of the reference's bf16 and float32
gradients (they read 9.4e-2; XLA's CPU reduction of a bf16 bias gradient
keeps bf16 partial sums and moves with the CPU, ROADMAP Queue 3); BatchNorm statistics 1e-6; a 3-step trajectory's losses 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from tests.torch_golden import (
    FUSION_ASSET,
    GOLDEN_FUSION,
    GOLDEN_TRAIN,
    jax_module_from_arrays,
    load_npz,
    random_arrays,
    to_jax_config,
)
from tpufusion.models import fusion as jax_fusion
from tpufusion.models import io as jax_io
from tpufusion.train import fusion_trainer as jax_fusion_trainer
from tpufusion_torch import _golden
from tpufusion_torch.config import CameraConfig, ModelConfig
from tpufusion_torch.geometry.range_view import range_view_project_batch
from tpufusion_torch.models import fusion, io as models_io
from tpufusion_torch.models.fusion import (
    FusionNet,
    dropout,
    fusion_loss,
    init_fusion_,
    trainable_parameters,
)
from tpufusion_torch.train.fusion_trainer import (
    make_fusion_train_step,
    make_fusion_tx,
    train_fusion,
)
from tpufusion_torch.train.optim import Adam

CAMERA = CameraConfig(width=93, height=64)
LIDAR_HW = (32, 201)
GEOMETRY = dict(camera=CAMERA, lidar_hw=LIDAR_HW, lidar_pool=(2, 8), cam_pool=(8, 8))


def t(a):
    return torch.from_numpy(np.array(a))


def _models(dtype="float32"):
    return dict(
        lidar_model=ModelConfig(dtype=dtype),
        camera_model=ModelConfig(vertical_stride=2, use_regression=False, dtype=dtype),
    )


def _port_net(arrays=None, dtype="float32", seed=0):
    net = FusionNet(**_models(dtype), **GEOMETRY)
    if arrays is None:
        init_fusion_(net, seed)
    else:
        models_io.load_arrays(net, arrays)
    return net


def _jax_net(arrays, dtype="float32", dropout_off=True):
    kw = {k: to_jax_config(v) for k, v in _models(dtype).items()}
    geometry = dict(GEOMETRY, camera=to_jax_config(CAMERA))
    net = jax_module_from_arrays(
        lambda: jax_fusion.FusionNet(**kw, **geometry, rngs=nnx.Rngs(0)), arrays)
    # jax_module_from_arrays leaves the dropouts' RNG state abstract: make it
    # concrete, so the whole net can be a jit argument and an optimizer's model
    def concrete(x):
        if not isinstance(x, jax.ShapeDtypeStruct):
            return x
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return jax.random.wrap_key_data(jnp.zeros(x.shape + (2,), jnp.uint32))
        return jnp.zeros(x.shape, x.dtype)

    nnx.update(net, jax.tree.map(concrete, nnx.state(net, nnx.RngState)))
    if dropout_off:
        for branch in (net.cam_branch, net.lidar_branch):
            branch.dropout1.rate = branch.dropout2.rate = 0.0
    return net


def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    lidar = np.zeros((n, *LIDAR_HW, 3), np.float32)
    lidar[..., 0] = rng.uniform(0, 40, (n, *LIDAR_HW)) * (rng.random((n, *LIDAR_HW)) > 0.4)
    lidar[..., 1] = rng.uniform(-2, 2, (n, *LIDAR_HW))
    lidar[..., 2] = rng.uniform(0, 1, (n, *LIDAR_HW))
    radar = np.stack([rng.uniform(5, 30, n), rng.uniform(-0.5, 0.5, n)], -1).astype(np.float32)
    centroid = np.stack([radar[:, 0] * np.cos(radar[:, 1]), radar[:, 0] * np.sin(radar[:, 1]),
                         np.full(n, -0.7)], -1).astype(np.float32)
    return {
        "cam": rng.uniform(0, 1, (n, CAMERA.height, CAMERA.width, 1)).astype(np.float32),
        "lidar": lidar, "radar": radar, "centroid": centroid,
        "rz": rng.uniform(-0.05, 0.05, (n, 1)).astype(np.float32),
    }


def _flat_grads(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_grads(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _jax_step(arrays, data, dtype="float32"):
    net = _jax_net(arrays, dtype)

    @nnx.jit
    def run(net, cam, lidar, radar, centroid, rz):
        def loss_fn(n):
            out = n(cam, lidar, radar, train=True)
            return jax_fusion.fusion_loss(out, (centroid, rz)), out
        return nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, nnx.Param), has_aux=True)(net)

    (loss, out), grads = run(net, *(jnp.asarray(data[k]) for k in
                                    ("cam", "lidar", "radar", "centroid", "rz")))
    stats = {f"{name}/norm/{s}": np.asarray(getattr(getattr(net, name).norm, s)[...])
             for name in ("lidar_fcn", "camera_fcn") for s in ("mean", "var")}
    return float(loss), [np.asarray(o) for o in out], _flat_grads(nnx.to_pure_dict(grads)), stats


def _port_step(arrays, data, dtype="float32"):
    net = _port_net(arrays, dtype)
    net.cam_branch.rate = net.lidar_branch.rate = 0.0
    out = net(t(data["cam"]), t(data["lidar"]), t(data["radar"]), train=True)
    loss = fusion_loss(out, (t(data["centroid"]), t(data["rz"])))
    loss.backward()
    grads = {n.replace(".", "/"): (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
             for n, p in net.named_parameters()}
    stats = {k.replace(".", "/"): v.numpy() for k, v in net.state_dict().items()
             if k.endswith(("norm.mean", "norm.var"))}
    return float(loss.detach()), [o.detach().numpy() for o in out], grads, stats


def _rel(got, want):
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30)) for k in want}


@pytest.fixture(scope="module")
def arrays():
    return random_arrays(_port_net(), seed=2)


@pytest.fixture(scope="module")
def jax_f32_step(arrays):
    return _jax_step(arrays, _data())


def test_fusion_train_forward_loss_and_gradients_match(arrays, jax_f32_step):
    want_loss, want_out, want, wstats = jax_f32_step
    got_loss, got_out, got, gstats = _port_step(arrays, _data())
    for g, w in zip(got_out, want_out):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    rel = _rel(got, want)
    assert sorted(got) == sorted(want) and max(rel.values()) <= 1e-4, rel
    # the lidar FCN's regression branch is not on the features' path
    assert np.abs(want["lidar_fcn/deconv6b/kernel"]).max() == 0.0
    assert np.abs(want["lidar_fcn/conv1/kernel"]).max() > 0
    for k, w in wstats.items():
        np.testing.assert_allclose(gstats[k], w, rtol=1e-6, atol=1e-6, err_msg=k)
    assert not np.array_equal(gstats["camera_fcn/norm/mean"], arrays["camera_fcn/norm/mean"])


def test_fusion_train_gradients_match_in_bf16(arrays, jax_f32_step):
    _, _, want32, _ = jax_f32_step
    want_loss, _, want, wstats = _jax_step(arrays, _data(), "bfloat16")
    got_loss, _, got, gstats = _port_step(arrays, _data(), "bfloat16")
    assert got_loss == pytest.approx(want_loss, rel=2.0**-8)
    rel, rel32 = _rel(got, want), _rel(got, want32)
    conv_bias = [k for k in rel if "_fcn/" in k and k.endswith("/bias") and "/norm/" not in k]
    rest = {k: v for k, v in rel.items() if k not in conv_bias}
    assert max(rest.values()) <= 2.0**-6, rest
    nearer = {k: min(rel[k], rel32[k]) for k in conv_bias}
    assert max(nearer.values()) <= 2.0**-2, nearer
    for k, w in wstats.items():
        np.testing.assert_allclose(gstats[k], w, rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [(2, 8), (8, 8), (4, 1)])
def test_max_pool_gradient_ties_go_where_the_references_go(pool, dtype):
    """Equal values in a window are common in a bf16 feature map: both
    frameworks send the gradient to the first maximum in row-major order."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (2, 16, 40, 2)).astype(np.float32)  # many ties
    w = rng.normal(size=(2, 16 // pool[0], 40 // pool[1], 2)).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = jax.grad(lambda a: (nnx.max_pool(a.astype(jd), pool, pool, "VALID")
                               .astype(jnp.float32) * w).sum())(jnp.asarray(x))
    xt = t(x).requires_grad_()
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    (fusion._max_pool_nhwc(xt.to(td), pool).float() * t(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    windows = x[:, :pool[0], :pool[1]].reshape(2, -1, 2)
    assert ((windows == windows.max(axis=1, keepdims=True)).sum(axis=1) > 1).any()


def test_fusion_loss_matches():
    rng = np.random.default_rng(1)
    c, tc = rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=(5, 3)).astype(np.float32)
    r, tr = rng.normal(size=(5, 1)).astype(np.float32), rng.normal(size=(5, 1)).astype(np.float32)
    want = float(jax_fusion.fusion_loss((jnp.asarray(c), jnp.asarray(r)), (jnp.asarray(tc), jnp.asarray(tr))))
    assert float(fusion_loss((t(c), t(r)), (t(tc), t(tr)))) == pytest.approx(want, rel=1e-6)


def test_dropout_keep_share_scale_and_determinism():
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.2, gen)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 5e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert float(y.mean()) == pytest.approx(1.0, abs=5e-3)  # the expectation is kept
    again = dropout(x, 0.2, torch.Generator().manual_seed(0))
    other = dropout(x, 0.2, torch.Generator().manual_seed(1))
    assert torch.equal(y, again) and not torch.equal(y, other)
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.2, None)


def test_dropout_runs_in_training_only(arrays):
    net = _port_net(arrays)
    d = _data(4)
    args = (t(d["cam"]), t(d["lidar"]), t(d["radar"]))
    eval_a, eval_b = net(*args), net(*args)
    assert torch.equal(eval_a[0], eval_b[0])
    stats = {k: v.clone() for k, v in net.state_dict().items()}
    one = net(*args, train=True, generator=torch.Generator().manual_seed(3))
    for k in ("lidar_fcn.norm.mean", "camera_fcn.norm.var"):
        net.state_dict()[k].copy_(stats[k])  # the same statistics for the second draw
    two = net(*args, train=True, generator=torch.Generator().manual_seed(3))
    three = net(*args, train=True, generator=torch.Generator().manual_seed(4))
    assert torch.equal(one[0], two[0]) and not torch.equal(one[0], three[0])
    with pytest.raises(ValueError, match="Generator"):
        net(*args, train=True)


@pytest.mark.parametrize("lock_lidar, lock_camera", [(False, False), (True, False), (False, True), (True, True)])
def test_trainable_parameters_follow_the_references_filter(arrays, lock_lidar, lock_camera):
    net = _port_net(arrays)
    got = {id(p) for p in trainable_parameters(net, lock_lidar, lock_camera)}
    names = {n.replace(".", "/") for n, p in net.named_parameters() if id(p) in got}
    predicate = jax_fusion.trainable_filter(lock_lidar, lock_camera)
    jnet = _jax_net(arrays)
    want = {"/".join(map(str, path)) for path, value in nnx.iter_graph(jnet)
            if isinstance(value, nnx.Variable) and predicate(path, value)}
    assert names == want
    assert ("lidar_fcn/conv1/kernel" in names) == (not lock_lidar)
    assert ("camera_fcn/conv1/kernel" in names) == (not lock_camera)
    assert "centroid_head/out/kernel" in names and "lidar_fcn/norm/mean" not in names


def test_init_fusion_draws_the_references_distributions():
    a, b, c = _port_net(seed=0), _port_net(seed=0), _port_net(seed=1)
    for name, p in a.named_parameters():
        if name.endswith("bias") and "norm" not in name:
            assert float(p.abs().max()) == 0.0, name
    k = a.cam_branch.dense1.kernel.detach()
    assert torch.equal(k, b.cam_branch.dense1.kernel.detach())
    assert not torch.equal(k, c.cam_branch.dense1.kernel.detach())
    assert float(k.abs().max()) <= 0.05 and abs(float(k.std()) - 0.1 / 12**0.5) < 1e-3
    assert float(a.lidar_fcn.conv1.kernel.abs().max()) <= 0.05
    out = torch.cat([_port_net(seed=s).centroid_head.out.kernel.detach().flatten() for s in range(40)])
    std = (1.0 / 6) ** 0.5  # lecun normal: variance 1 / fan_in, fan_in = 6
    assert abs(float(out.std()) - std) < 0.05 * std * 3
    assert float(out.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6  # truncated at 2 sigma


def test_fusion_tx_is_the_references_plateau_rule():
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt = make_fusion_tx(p, 1e-3, steps_per_epoch=7, device="cpu")
    assert isinstance(opt, Adam) and opt.param_groups[0]["lr"] == 1e-3
    rule = opt.plateau
    assert (rule.patience, rule.factor, rule.accumulation_size, rule.cooldown) == (3, 0.5, 7, 1)


def test_fusion_step_trajectory_matches(arrays):
    """Three steps of make_fusion_train_step (Adam under the plateau rule,
    dropout off) on the same rows: the losses."""
    data = _data(8, seed=3)
    jnet = _jax_net(arrays)
    jopt = nnx.Optimizer(jnet, jax_fusion_trainer.make_fusion_tx(1e-3, 2), wrt=nnx.Param)
    jstep = jax_fusion_trainer.make_fusion_train_step()
    net = _port_net(arrays)
    net.cam_branch.rate = net.lidar_branch.rate = 0.0
    opt = make_fusion_tx(net.parameters(), 1e-3, 2, device="cpu")
    step = make_fusion_train_step()
    keys = ("cam", "lidar", "radar", "centroid", "rz")
    jdev, dev = [jnp.asarray(data[k]) for k in keys], [t(data[k]) for k in keys]
    want, got = [], []
    for rows in ([0, 1, 2, 3], [4, 5, 6, 7], [1, 3, 5, 7]):
        want.append(float(jstep(jnet, jopt, *jdev, jnp.asarray(rows))))
        got.append(float(step(net, opt, *dev, torch.tensor(rows))))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert opt.count == 3 and int(opt.plateau.count) == 1


def test_train_fusion_loss_falls_and_locks_hold():
    data = _data(16, seed=4)
    net = _port_net(seed=0)
    losses = train_fusion(net, data, epochs=6, batch_size=4, lr=3e-3, device="cpu")
    assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0]
    again = _port_net(seed=0)
    assert train_fusion(again, data, epochs=6, batch_size=4, lr=3e-3, device="cpu") == losses

    before = {k: v.clone() for k, v in net.state_dict().items()}
    train_fusion(net, data, epochs=1, batch_size=4, lock_lidar=True, lock_camera=True, device="cpu")
    after = net.state_dict()
    for name, _ in net.named_parameters():
        same = torch.equal(before[name], after[name])
        assert same == name.startswith(("lidar_fcn.", "camera_fcn.")), name
    # as in the reference, a locked FCN still runs with train=True: its statistics move
    assert not torch.equal(before["lidar_fcn.norm.mean"], after["lidar_fcn.norm.mean"])
    # a partial last batch is dropped; fewer frames than a batch take no step
    assert train_fusion(net, {k: v[:3] for k, v in data.items()}, epochs=2, batch_size=4,
                        device="cpu") == [0.0, 0.0]


def test_fusion_weights_cross_both_ways(tmp_path, arrays):
    net = _port_net(arrays)
    path = str(tmp_path / "port_fusion.npz")
    models_io.save_state_npz(path, net)
    kw = {k: to_jax_config(v) for k, v in _models().items()}
    jnet = jax_fusion.FusionNet(**kw, **dict(GEOMETRY, camera=to_jax_config(CAMERA)), rngs=nnx.Rngs(5))
    jax_io.load_state_npz(path, jnet)
    d = _data(2)
    want = nnx.jit(lambda n, c, l, r: n(c, l, r, train=False))(
        jnet, jnp.asarray(d["cam"]), jnp.asarray(d["lidar"]), jnp.asarray(d["radar"]))
    got = net(t(d["cam"]), t(d["lidar"]), t(d["radar"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    back = str(tmp_path / "jax_fusion.npz")
    jax_io.save_state_npz(back, jnet)
    again = _port_net(seed=9)
    models_io.load_state_npz(back, again)
    for (ka, va), (kb, vb) in zip(net.state_dict().items(), again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


# -- the full-size fusion step of the train golden ---------------------------------------

@pytest.fixture(scope="module")
def fusion_golden_step():
    gf, gt = load_npz(GOLDEN_FUSION), load_npz(GOLDEN_TRAIN)
    data = _golden.fusion_golden_data("cpu")
    assert np.array_equal(data["cam_sha256"], gf["fusion_cam_sha256"])
    data["radar"] = gf["fusion_radar"]
    with torch.no_grad():
        lidar = range_view_project_batch(t(gf["fusion_points"]), valid=t(gf["fusion_valid"]))
    return gt, data, lidar


@pytest.mark.parametrize("tag, dtype", [("f32", "float32"), ("bf16", "bfloat16")])
def test_port_fusion_step_matches_the_train_golden(fusion_golden_step, tag, dtype):
    """What chip_smoke.py phase 17 checks on the card, here on the CPU: the
    shipped asset at full width (camera 512 x 1368) on the golden's 8 frames."""
    gt, data, lidar = fusion_golden_step
    got = _golden.port_fusion_step(FUSION_ASSET, dtype, data, lidar, "cpu")
    r = _golden.fusion_step_readings(got, gt, tag)
    assert r["loss_rel"] <= _golden.FUSION_TRAIN_LOSS_RTOL[tag], r
    assert not r["over"], r
    assert r["stats_abs"] <= 1e-6


def test_batchnorm_variance_form_costs_the_reference_digits(fusion_golden_step):
    """ROADMAP Queue 3, "BatchNorm variance form". The golden's lidar frames
    hold 4,096 points, so the height channel is nearly constant and
    E[x^2] - E[x]^2 in float32 cancels. The port's float32 lidar-FCN
    gradients agree with a float64 run of the same step to 1e-4; the
    reference's float32 ones lie further than 5e-4 from it."""
    gt, data, lidar = fusion_golden_step
    f32 = _golden.port_fusion_step(FUSION_ASSET, "float32", data, lidar, "cpu")

    real = models_io.fusion_from_asset

    def as_double(path, device, dtype):
        net = real(path, device, dtype).double()
        net.lidar_fcn.compute_dtype = net.camera_fcn.compute_dtype = torch.float64
        return net

    dense_forward = fusion.Dense.forward
    fusion.Dense.forward = lambda self, x: x.to(self.kernel.dtype) @ self.kernel + self.bias
    try:
        models_io.fusion_from_asset = as_double
        f64 = _golden.port_fusion_step(FUSION_ASSET, "float32", data, lidar, "cpu")
    finally:
        models_io.fusion_from_asset = real
        fusion.Dense.forward = dense_forward
    port_gap, ref_gap = 0.0, 0.0
    for key in ("lidar_fcn/conv1/kernel", "lidar_fcn/conv3/kernel", "lidar_fcn/deconv4/kernel"):
        scale = float(gt[f"fusion_f32/grad_max/{key}"])
        exact = f64["grads"][key]
        port_gap = max(port_gap, float(np.abs(f32["grads"][key] - exact).max()) / scale)
        ref_gap = max(ref_gap, float(np.abs(
            gt[f"fusion_f32/grad/{key}"] - _golden.grad_sample(exact)).max()) / scale)
    assert port_gap <= 1e-4 < 5e-4 <= ref_gap, (port_gap, ref_gap)
