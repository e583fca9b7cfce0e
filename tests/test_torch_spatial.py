"""The spatial mesh axis (`parallel/mesh.py`, `parallel/halo.py` and the
width-sharded FCN of `models/fcn.py`), on the CPU.

Four gloo ranks are spawned once for the module. Each runs a 2 data x 2
spatial mesh first (the layout the reference's dry run gives four
devices), then a 1 x 4 mesh on the same world, and writes what it computed
to a temp dir; the checks run here. At width 201 (32 x 201 range view) a
global batch of 8 uniform clouds of 512 points; at 32 x 1801, 4 clouds of
4,096 points.

Limits, against the port's one-process answer on the same global batch:
  the train step    the dry run's (`parallel/dryrun.py`): loss and metrics
                    1e-5 relative, gradients 2e-3 of each tensor's largest
                    entry, updated parameters 1e-5 where |g| > 1e-6,
                    running statistics 1e-6 of each buffer's largest entry
                    (absolute below 1); in bf16 the train golden's bf16
                    limits (`_golden.py`: loss 2^-8, gradients 2^-6, conv
                    biases 2^-4)
  the e2e phases    `found` equal, poses within 1e-4
  the FCN           forward and input gradient within 1e-5 of the largest
                    entry
and every rank's parameters and statistics equal rank 0's bit for bit.
Against the reference's own 2 x 2 step (`tpufusion.parallel.mesh` on four
of the eight virtual devices of tests/conftest.py, the roll off) the limits
are the train golden's. The halo exchanges receive at most one kernel
width (5 columns) from the two neighbours together, each strip counted
once per other rank of the row.

The small floats (F8_CASES): the f8 mesh golden's step (`_golden.py`,
F8_MESH_*: the flagship FCN without its input norm, 4 frames at 32 x
201) in float8_e4m3fn and float8_e5m2 on both layouts, held to JAX's
train step on the same mesh of virtual devices (its gradients read back
from an SGD step at a rate of 1, `make_torch_port_golden.jax_f8_mesh_step`;
the 2 x 2 float8_e4m3fn step is the golden file's): every gradient bit
for bit, the loss within LOSS_RTOL, every rank's parameters equal to the
port's Adam on JAX's gradients bit for bit. With the input norm, the one
process's limits of tests/test_torch_small_float_train.py.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from tpufusion_torch import _golden
from tpufusion_torch.config import DecodeConfig, LossConfig, MeshConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.data.synthetic import synthesize_points_batch
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.parallel import dryrun
from tpufusion_torch.parallel.halo import halo_plan
from tpufusion_torch.parallel.mesh import (
    Mesh,
    all_gather_columns,
    column_blocks,
    constrain_spatial,
    make_mesh,
    replicate,
    shard_batch,
)
from tpufusion_torch.predict import make_e2e_step
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.train_step import make_train_step

SPEC = RangeViewSpec(res_h_deg=1.8)  # 32 x 201
FULL = RangeViewSpec()  # 32 x 1801
RANKS, BATCH, POINTS, FULL_FRAMES, FULL_POINTS = 4, 8, 512, 4, 4096
LAYOUTS = {"2x2": MeshConfig(n_devices=RANKS, n_spatial=2), "1x4": MeshConfig(n_devices=RANKS, n_spatial=4)}
SPAWN_TIMEOUT = 300
KERNEL_WIDTH = 5
SAMPLE_WISE = ModelConfig(sample_wise_bn=True, batch_norm=False)
FLAGSHIP = dataclasses.replace(ModelConfig(), head="direct", width_multiplier=2, reg_output_activation="linear")
# each rank's train steps: (model config, loss config, augment, weights from the
# arrays file). bf16 runs on the 2 x 2 layout only: at width 201 the 1 x 4
# layout leaves a rank one output column of conv3, and torch's bf16 conv on
# the CPU (oneDNN) gets a stride-2 conv with one output column wrong (1.85
# off where float32 differs by 3.5e-3, or NaN), sharded or not.
BF16_LAYOUTS = ("2x2",)
CASES = {
    "global": (ModelConfig(), LossConfig(), True, False),
    "sample_wise_compat": (SAMPLE_WISE, LossConfig(reference_compat=True), True, False),
    "sample_wise_bf16": (dataclasses.replace(SAMPLE_WISE, dtype="bfloat16"), LossConfig(), True, False),
    "reference": (ModelConfig(), LossConfig(), False, True),
}
# the e2e phases: (model config, head, spec, seed, frames, points, decode config)
E2E = {
    "corner_201": (ModelConfig(), "corner", SPEC, 1, BATCH, POINTS, DecodeConfig()),
    "flagship_201": (FLAGSHIP, "direct", SPEC, 1, BATCH, POINTS, DecodeConfig()),
    "flagship_1801": (FLAGSHIP, "direct", FULL, 4, FULL_FRAMES, FULL_POINTS, DecodeConfig(min_bbox_area=20.0)),
}


def _global_batch():
    pts, gt = synthesize_points_batch(np.random.default_rng(1), BATCH, POINTS)
    return {"points": pts, **gt}


def _model(mcfg, arrays=None):
    model = FCN(mcfg, image_hw=(SPEC.height, SPEC.width), seed=0)
    if arrays is not None:
        models_io.load_arrays(model, arrays)
    return model


def _run_step(model, batch, step) -> dict:
    loss, metrics = step(model, Adam(model.parameters(), 1e-3), batch, torch.Generator().manual_seed(2))
    out = {"loss": loss.numpy(), **{f"metric/{k}": v.numpy() for k, v in metrics.items()}}
    for name, p in model.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
        out[f"param/{name}"] = p.detach().numpy()
    out.update({f"buffer/{n}": b.numpy() for n, b in model.named_buffers()})
    return out


def _fcn_inputs(width: int):
    x = np.random.default_rng(3).normal(size=(2, 32, width, 3)).astype(np.float32) * 5.0
    g = np.random.default_rng(4).normal(size=(2, 32, width, 2 + FCN(FLAGSHIP).num_reg_channels))
    return torch.from_numpy(x), torch.from_numpy(g.astype(np.float32))


# each rank's small-float steps: (format, input norm)
F8_CASES = {"f8_e4m3fn": ("float8_e4m3fn", False), "f8_e5m2": ("float8_e5m2", False),
            "f8_norm": ("float8_e4m3fn", True)}


def _run_layout(mesh, layout: str, outdir: str) -> None:
    """One layout's checks on this rank."""
    def save(name, **arrays):
        np.savez(os.path.join(outdir, f"{layout}_{name}_rank{mesh.rank}.npz"), **arrays)

    for case, (name, norm) in F8_CASES.items():
        save(case, **dryrun.small_float_step(mesh, name, norm))

    arrays = dict(np.load(os.path.join(outdir, "arrays.npz")))
    batch = shard_batch(_global_batch(), mesh)
    for case, (mcfg, loss_cfg, augment, from_arrays) in CASES.items():
        if case == "sample_wise_bf16" and layout not in BF16_LAYOUTS:
            continue
        model = replicate(_model(mcfg, arrays if from_arrays else None), mesh)
        step = make_train_step(SPEC, loss_cfg, TrainConfig(batch_size=BATCH, augment=augment), mesh=mesh)
        mesh.halo.reset()
        mesh.halo.keep = case == "global"
        out = _run_step(model, batch, step)
        mesh.halo.keep = False
        if case == "global":
            out.update(halo_received=np.array([r["received"] for r in mesh.halo.records]),
                       halo_columns=np.array([mesh.halo.calls, mesh.halo.columns, mesh.halo.grad_columns]))
        save(case, **out)

    for phase, (mcfg, head, spec, seed, frames, points, dcfg) in E2E.items():
        pts, _ = synthesize_points_batch(np.random.default_rng(seed), frames, points)
        model = replicate(FCN(mcfg, seed=0), mesh)
        poses, found = make_e2e_step(model, spec, dcfg, head=head, mesh=mesh)(
            shard_batch({"points": pts}, mesh)["points"])
        save(phase, poses=poses.numpy(), found=found.numpy())

    model = FCN(FLAGSHIP, seed=0)
    for width in (SPEC.width, FULL.width):
        x, g = _fcn_inputs(width)
        xl = constrain_spatial(x, mesh).clone().requires_grad_(True)
        mesh.halo.reset()
        y = model(xl, mesh=mesh, width=width)
        (y * constrain_spatial(g, mesh)).sum().backward()
        save(f"fcn_{width}", out=all_gather_columns(y.detach(), mesh, width).numpy(),
             grad=all_gather_columns(xl.grad, mesh, width).numpy(),
             halo=np.array([mesh.halo.calls, mesh.halo.columns, mesh.halo.grad_columns]))

    save("layout", shape=np.array(list(mesh.shape.values())), axes=np.array(mesh.axis_names),
         coords=np.array([mesh.data_index, mesh.spatial_index]))


def _rank_checks(mesh, outdir):
    _run_layout(mesh, "2x2", outdir)
    _run_layout(make_mesh(LAYOUTS["1x4"], mesh.device), "1x4", outdir)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    from tests.torch_golden import random_arrays

    outdir = str(tmp_path_factory.mktemp("spatial"))
    arrays = random_arrays(FCN(ModelConfig()), seed=5)
    np.savez(os.path.join(outdir, "arrays.npz"), **arrays)
    dryrun.spawn(_rank_checks, RANKS, "cpu", args=(outdir,), timeout=SPAWN_TIMEOUT, mesh_cfg=LAYOUTS["2x2"])

    def load(layout, name, rank=0):
        return dict(np.load(os.path.join(outdir, f"{layout}_{name}_rank{rank}.npz")))

    return load, arrays


def _one_process(case, arrays):
    mcfg, loss_cfg, augment, from_arrays = CASES[case]
    model = _model(mcfg, arrays if from_arrays else None)
    step = make_train_step(SPEC, loss_cfg, TrainConfig(batch_size=BATCH, augment=augment), device="cpu")
    return _run_step(model, {k: torch.from_numpy(v) for k, v in _global_batch().items()}, step)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", ["global", "sample_wise_compat"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_step_matches_one_process(layout, case, four_ranks):
    """The roll on, drawn for the global batch and applied at full width
    before the cut: BatchNorm (or SampleWiseBN, its statistics over the
    data axis only, with reference_compat's batch-wide regression norm)
    over the global batch, each rank's gradient share summed over spatial
    and averaged over data, the global loss and metrics."""
    load, arrays = four_ranks
    got, want = load(layout, case), _one_process(case, arrays)
    assert abs(float(got["loss"] - want["loss"])) <= dryrun.LOSS_RTOL * abs(float(want["loss"]))
    for k in (k for k in want if k.startswith("metric/")):
        assert abs(float(got[k] - want[k])) <= dryrun.LOSS_RTOL * max(abs(float(want[k])), 1e-30), k
    grads = [k for k in want if k.startswith("grad/")]
    worst = max(grads, key=lambda k: _rel(got[k], want[k]))
    assert _rel(got[worst], want[worst]) <= dryrun.GRAD_RTOL, (worst, _rel(got[worst], want[worst]))
    for k in grads:
        p = k.replace("grad/", "param/")
        moved = np.abs(want[k]) > dryrun.ADAM_FLOOR
        assert float((np.abs(got[p] - want[p]) * moved).max()) <= dryrun.PARAM_ATOL, p
    for k in (k for k in want if k.startswith("buffer/")):
        assert np.abs(got[k] - want[k]).max() <= dryrun.STATS_RTOL * max(np.abs(want[k]).max(), 1.0), k


@pytest.mark.parametrize("layout", BF16_LAYOUTS)
def test_spatial_step_in_bf16(layout, four_ranks):
    """SampleWiseBN with the FCN in bf16: the halo carries bf16 columns;
    against one process within the train golden's bf16 limits."""
    load, arrays = four_ranks
    got, want = load(layout, "sample_wise_bf16"), _one_process("sample_wise_bf16", arrays)
    assert abs(float(got["loss"] - want["loss"])) <= _golden.BF16_TRAIN_LOSS_RTOL * abs(float(want["loss"]))
    for k in (k for k in want if k.startswith("grad/")):
        limit = _golden.BF16_TRAIN_BIAS_GRAD_RTOL if k.endswith("bias") else _golden.BF16_TRAIN_GRAD_RTOL
        assert _rel(got[k], want[k]) <= limit, (k, _rel(got[k], want[k]))
    for k in (k for k in want if k.startswith("buffer/")):
        assert np.abs(got[k] - want[k]).max() <= dryrun.STATS_RTOL * max(np.abs(want[k]).max(), 1.0), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_every_rank_holds_rank0s_parameters_and_statistics(layout, four_ranks):
    """One flat all-reduce: every rank takes the same step. SampleWiseBN's
    running buffers, each rank moving its own positions, are gathered
    whole on every rank."""
    load, _ = four_ranks
    for case in CASES:
        if case == "sample_wise_bf16" and layout not in BF16_LAYOUTS:
            continue
        lead = load(layout, case)
        for rank in range(1, RANKS):
            other = load(layout, case, rank)
            for k in (k for k in lead if k.split("/")[0] in ("param", "buffer", "loss", "metric")):
                np.testing.assert_array_equal(other[k], lead[k], err_msg=f"{layout} {case} rank {rank}: {k}")


def test_spatial_step_matches_the_reference_2x2_step(four_ranks):
    """The reference's make_train_step(..., mesh=make_mesh(MeshConfig(
    n_devices=4, n_spatial=2))) on the same weights and global batch, the
    roll off: its loss, metrics and BatchNorm statistics, and the gradients
    of its loss under the same mesh, within the train golden's limits."""
    import jax
    import optax
    from flax import nnx

    from tests.torch_golden import jax_model_from_arrays, to_jax_config
    from tpufusion.geometry.encoding import encode_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.models.losses import weighted_pose_loss
    from tpufusion.parallel import mesh as jax_mesh
    from tpufusion.train import train_step as jax_train_step

    load, arrays = four_ranks
    got = load("2x2", "reference")
    jmesh = jax_mesh.make_mesh(to_jax_config(LAYOUTS["2x2"]))
    assert jmesh.axis_names == ("data", "spatial")
    jspec, jloss = to_jax_config(SPEC), to_jax_config(LossConfig())
    sh = jax_mesh.batch_sharding(jmesh)
    jbatch = {k: jax.device_put(v, sh) for k, v in _global_batch().items()}

    grad_model = jax_model_from_arrays(ModelConfig(), arrays)
    nnx.update(grad_model, jax_mesh.replicate(nnx.state(grad_model), jmesh))

    @nnx.jit
    def grads_of(m, b):
        images = range_view_project_batch(b["points"], jspec)
        labels = encode_label_batch(b["center"], b["size"], b["yaw"], images, jspec)
        images, labels = jax_mesh.constrain_spatial(images, jmesh), jax_mesh.constrain_spatial(labels, jmesh)
        return nnx.grad(lambda m: weighted_pose_loss(m(images, train=True), labels, jloss))(m)

    model = jax_model_from_arrays(ModelConfig(), arrays)
    opt = nnx.Optimizer(model, optax.adam(1e-3), wrt=nnx.Param)
    for mod in (model, opt):
        nnx.update(mod, jax_mesh.replicate(nnx.state(mod), jmesh))
    step = jax_train_step.make_train_step(
        jspec, jloss, to_jax_config(TrainConfig(batch_size=BATCH, augment=False)), mesh=jmesh)
    with jmesh:
        grads = grads_of(grad_model, jbatch)
        loss, metrics = step(model, opt, jbatch, jax.random.PRNGKey(2))
    assert abs(float(got["loss"]) - float(loss)) <= _golden.TRAIN_LOSS_RTOL * abs(float(loss))
    for k, v in metrics.items():
        assert float(got[f"metric/{k}"]) == pytest.approx(float(v), rel=1e-4, abs=1e-6), k
    flat = {f"grad/{a}.{b}": np.asarray(g, np.float32)
            for a, leaves in nnx.to_pure_dict(grads).items() for b, g in leaves.items()}
    assert sorted(flat) == sorted(k for k in got if k.startswith("grad/"))
    worst = max(_rel(got[k], w) for k, w in flat.items())
    assert worst <= _golden.TRAIN_GRAD_RTOL, worst
    for name in ("mean", "var"):
        np.testing.assert_allclose(got[f"buffer/norm.{name}"], np.asarray(getattr(model.norm, name)[...]),
                                   rtol=0, atol=_golden.TRAIN_STATS_ATOL)


@pytest.mark.parametrize("phase", list(E2E))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_spatial_e2e_matches_one_process(layout, phase, four_ranks):
    """Each data row projects its frames at full width, the FCN runs
    width-sharded, its maps are gathered back for the decode: `found`
    equal and poses within 1e-4 of one process; every rank of a data row
    decodes the same poses."""
    load, _ = four_ranks
    mcfg, head, spec, seed, frames, points, dcfg = E2E[phase]
    pts, _ = synthesize_points_batch(np.random.default_rng(seed), frames, points)
    want_poses, want_found = make_e2e_step(FCN(mcfg, seed=0), spec, dcfg, head=head, device="cpu")(pts)
    n_spatial = LAYOUTS[layout].n_spatial
    rows = [load(layout, phase, r) for r in range(0, RANKS, n_spatial)]
    poses = np.concatenate([r["poses"] for r in rows])
    found = np.concatenate([r["found"] for r in rows])
    np.testing.assert_array_equal(found, want_found.numpy())
    assert np.abs(poses - want_poses.numpy()).max() <= dryrun.POSE_ATOL
    for r in range(RANKS):
        lead = rows[r // n_spatial]
        other = load(layout, phase, r)
        np.testing.assert_array_equal(other["poses"], lead["poses"])
        np.testing.assert_array_equal(other["found"], lead["found"])
    if spec is FULL:
        assert found.any()


@pytest.mark.parametrize("width", [SPEC.width, FULL.width])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_fcn_matches_the_unsharded_fcn(layout, width, four_ranks):
    """The flagship FCN's forward and its input gradient, each layer
    computing its own columns of its global output (1804 -> 451 -> 226
    -> 113 -> 226 -> 452 -> 451 -> 1804 -> 1801; 204 -> 51 -> 26 -> 13 at
    201), within 1e-5 of the largest entry."""
    load, _ = four_ranks
    got = load(layout, f"fcn_{width}")
    x, g = _fcn_inputs(width)
    x.requires_grad_(True)
    y = FCN(FLAGSHIP, seed=0)(x)
    (y * g).sum().backward()
    assert _rel(got["out"], y.detach().numpy()) <= 1e-5
    assert _rel(got["grad"], x.grad.numpy()) <= 1e-5


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_halo_moves_only_the_neighbours_edge_columns(layout, four_ranks):
    """A train step makes 7 exchanges (conv1-3, deconv4, one fetch of
    cat4 for deconv5a and 5b, deconv6a, deconv6b), each receiving at most
    one kernel width of columns from the two neighbours together, and its
    backward returns as many; a forward alone at 32 x 1801 moves 16 (2 x
    2) or 66 (1 x 4) columns of a layer, never the width."""
    load, _ = four_ranks
    k = LAYOUTS[layout].n_spatial
    for rank in range(RANKS):
        got = load(layout, "global", rank)
        received = got["halo_received"]
        assert len(received) == 7 and (received <= (k - 1) * KERNEL_WIDTH).all(), received
        calls, columns, grad_columns = got["halo_columns"]
        assert calls == 7 and columns == received.sum() == grad_columns
        for width in (SPEC.width, FULL.width):
            calls, columns, grad_columns = load(layout, f"fcn_{width}", rank)["halo"]
            assert calls == 7 and columns == grad_columns == {2: 16, 4: 66}[k]


def test_layouts_follow_the_reference(four_ranks):
    """Rank d sits at data d // n_spatial, spatial d % n_spatial."""
    load, _ = four_ranks
    for layout, cfg in LAYOUTS.items():
        for rank in range(RANKS):
            got = load(layout, "layout", rank)
            assert got["axes"].tolist() == ["data", "spatial"]
            assert got["shape"].tolist() == [RANKS // cfg.n_spatial, cfg.n_spatial]
            assert got["coords"].tolist() == [rank // cfg.n_spatial, rank % cfg.n_spatial]


def _fake_mesh(n_spatial: int, rank: int = 0) -> Mesh:
    return Mesh(group=None, rank=rank, world_size=n_spatial, device=torch.device("cpu"), backend="gloo",
                axis_names=("data", "spatial"), n_spatial=n_spatial)


def test_too_narrow_shards_raise():
    """GSPMD's blocks (ceil(W / k) columns, the rest last): a width that
    leaves a rank no column, a window that reaches past a neighbour's
    block, and a layer too narrow for its ranks all raise before anything
    is exchanged."""
    assert [(b.start, b.stop) for b in column_blocks(1801, 2)] == [(0, 901), (901, 1801)]
    assert [(b.start, b.stop) for b in column_blocks(201, 2)] == [(0, 101), (101, 201)]
    assert [b.stop - b.start for b in column_blocks(13, 4)] == [4, 4, 4, 1]
    with pytest.raises(ValueError, match="leaves a block empty"):
        column_blocks(6, 4)
    plan = halo_plan(9, [(0, 5), (2, 7), (5, 9)])
    assert (plan.left, plan.right, plan.received) == ((0, 1, 1), (2, 1, 0), 2 * (2 + 1))
    with pytest.raises(ValueError, match="reaches past its neighbours' blocks"):
        halo_plan(9, [(0, 7), (3, 6), (6, 9)])
    with pytest.raises(ValueError, match="reaches past its neighbours' blocks"):
        halo_plan(9, [(0, 3), (3, 6), (2, 9)])
    x = torch.zeros(1, 32, 3, 3)  # rank 0's block of a width of 9: conv1's 3 columns over 4 ranks
    with pytest.raises(ValueError, match="leaves a block empty"):
        FCN(ModelConfig(), seed=0)(x, mesh=_fake_mesh(4), width=9)
    with pytest.raises(ValueError, match="global width"):
        FCN(ModelConfig(), seed=0)(x, mesh=_fake_mesh(4))
    with pytest.raises(ValueError, match="does not round-trip"):
        FCN(ModelConfig(), seed=0)(torch.zeros(1, 32, 91, 3), mesh=_fake_mesh(2), width=181)


@functools.lru_cache(maxsize=None)
def _jax_mesh_step(layout: str, name: str, norm: bool) -> dict:
    """JAX's small-float train step on `layout`'s mesh of virtual devices:
    {"loss", "<layer>.<param>": gradient}; the golden file's where it
    holds the step."""
    from tests.make_torch_port_golden import jax_f8_mesh_step

    if layout == "2x2" and name == _golden.F8_MESH_NAME and not norm:
        return _golden_step(layout)
    out = jax_f8_mesh_step(RANKS, LAYOUTS[layout].n_spatial, name, norm)
    return {k.replace("/", "."): v for k, v in out.items()}


def _golden_step(layout: str) -> dict:
    from tests.torch_golden import GOLDEN_F8_MESH
    from tpufusion_torch.ops.small_float import FORMATS, decode

    golden = _golden.load_npz(GOLDEN_F8_MESH)
    fmt = FORMATS[_golden.F8_MESH_NAME]
    out = {"loss": golden[f"{layout}/loss"]}
    for k, v in golden.items():
        if k.startswith(layout + "/") and not k.endswith("/loss"):
            out[k[len(layout) + 1:].replace("/", ".")] = decode(torch.from_numpy(v), fmt).numpy()
    return out


def _same_values(got, want) -> bool:
    """Equal values, NaN where the other is NaN."""
    return got.shape == want.shape and bool(np.all((got == want) | (np.isnan(got) & np.isnan(want))))


def _adam_on(grads: dict, name: str, norm: bool) -> dict:
    """The port's Adam (`small_float_step`'s rate) from the golden's
    weights, on `grads`: {"<param>": the parameter after one step}."""
    model = FCN(_golden.f8_mesh_config(name, norm), seed=_golden.F8_MESH_SEED)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(np.asarray(grads[n], np.float32)).clone()
    Adam(model.parameters(), 1e-3).step()
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", ["f8_e4m3fn", "f8_e5m2"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_small_float_step_matches_jaxs_same_mesh_step(layout, case, four_ranks):
    """Without the input norm: every rank's gradients equal JAX's step on
    the same mesh bit for bit (NaN where JAX's is), the loss within
    LOSS_RTOL, and every rank's parameters are the port's Adam on JAX's
    gradients, bit for bit."""
    load, _ = four_ranks
    name, norm = F8_CASES[case]
    want = _jax_mesh_step(layout, name, norm)
    adam = _adam_on(want, name, norm)
    for rank in range(RANKS):
        got = load(layout, case, rank)
        assert abs(float(got["loss"]) - float(want["loss"])) <= dryrun.LOSS_RTOL * abs(float(want["loss"]))
        off = {k: float(np.mean(got[f"grad/{k}"] == want[k])) for k in adam
               if not _same_values(got[f"grad/{k}"], want[k])}
        assert not off, (rank, off)
        assert [k for k in adam if not np.array_equal(got[f"param/{k}"], adam[k])] == [], rank


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_small_float_step_with_the_norm_within_the_one_process_limits(layout, four_ranks):
    """float8_e4m3fn with the input norm, whose float32 statistics both
    packages sum in their own orders: each convolution's gradient within
    GRAD_DIFFER of its values off JAX's same-mesh step's (at least one)
    and none more than GRAD_STEPS steps of the format, the norm's
    gradients within NORM_FLIP_RTOL of their largest entry, the loss
    within NORM_LOSS_RTOL (tests/test_torch_small_float_train.py's limits
    for one process); every rank holds rank 0's parameters."""
    from tests.test_torch_small_float_train import GRAD_DIFFER, GRAD_STEPS, NORM_FLIP_RTOL, NORM_LOSS_RTOL
    from tpufusion_torch.ops.small_float import FORMATS

    load, _ = four_ranks
    name, norm = F8_CASES["f8_norm"]
    want = _jax_mesh_step(layout, name, norm)
    got = load(layout, "f8_norm")
    assert abs(float(got["loss"]) - float(want["loss"])) <= NORM_LOSS_RTOL * abs(float(want["loss"]))
    for k in (k for k in want if k != "loss"):
        g = got[f"grad/{k}"]
        if k.startswith("norm."):
            assert np.abs(g - want[k]).max() <= NORM_FLIP_RTOL * max(np.abs(want[k]).max(), 1e-30), k
            continue
        steps = _golden.format_steps(g, want[k], FORMATS[name])
        assert int((steps > 0).sum()) <= max(1, GRAD_DIFFER * steps.size), (k, int((steps > 0).sum()))
        assert int(steps.max()) <= GRAD_STEPS, k
    for rank in range(1, RANKS):
        other = load(layout, "f8_norm", rank)
        assert all(np.array_equal(other[k], got[k]) for k in got if k.startswith(("param/", "grad/")))
