"""Data parallelism over the batch (`tpufusion_torch/parallel/`), on the CPU.

Four gloo ranks are spawned once for the module (as tests/test_multichip.py
runs the reference on eight virtual devices): width 201 (32 x 201 range
view), a global batch of 16 uniform clouds of 512 points, 4 frames a rank.
Each rank writes what it computed to a file and the checks run here.

Limits, each against the one-process step of the port on the same global
batch (the roll on, drawn from one seeded generator):
  loss and metrics   1e-6 relative        (they read ~1e-7)
  gradients          2e-3 of each tensor's largest entry, the dry run's
                     limit (they read 4e-6 alone and up to 2e-4 under
                     pytest-xdist, whose workers run torch on one thread:
                     the sums run in another order, and the regression
                     head's small gradients are sums that cancel; a
                     fault reads 0.17)
  updated parameters 1e-6 where |g| > 1e-6 (they read ~1e-8; Adam's first
                     step lr g / (|g| + 1e-8) moves a near-zero entry by
                     up to lr whatever the last bits of g)
  BatchNorm stats    1e-6 of each buffer's largest entry, or absolute
                     below 1 (they read 8e-8; SampleWiseBN's 1.7e-7,
                     both passes of its variance run alike on a mesh and
                     off it)
and every rank's parameters and statistics equal rank 0's bit for bit.
A BatchNorm with per-rank statistics (DDP's default) fails them. Against
the reference's four-device sharded step (`tpufusion.parallel.mesh`, the
roll off) the limits are the single-process train golden's (_golden.py).

The small floats: ranks 0 and 1 also form a data x 2 and a 1 x 2 spatial
mesh of their own (`_pair_mesh`) and run the f8 mesh golden's step
(`_golden.py`, F8_MESH_*) on each, and all four ranks run it as data x 4.
Every gradient equals JAX's train step on the same mesh bit for bit (the
golden file's for float8_e4m3fn on data x 2 and 1 x 2, a live JAX step
otherwise), the loss within 1e-5; today's data-parallel path for a small
float (each rank's loss over its own rows, `average_gradients`' float32
mean of the rounded gradients) does not (the negative control).
"""

import os

import numpy as np
import pytest
import torch

from tpufusion_torch.config import LossConfig, MeshConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.data.pipeline import BatchPipeline
from tpufusion_torch.data.synthetic import synthesize_points_batch
from tpufusion_torch.models import fcn as port_fcn
from tpufusion_torch.models import io as models_io
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.parallel import dryrun
from tpufusion_torch.parallel.mesh import (
    BatchSharding,
    Mesh,
    batch_sharding,
    constrain_spatial,
    image_sharding,
    make_mesh,
    replicate,
    replicated_sharding,
    shard_batch,
)
from tpufusion_torch.train.optim import Adam
from tpufusion_torch.train.train_step import make_train_step

SPEC = RangeViewSpec(res_h_deg=1.8)
RANKS, BATCH, POINTS = 4, 16, 512
LOSS_RTOL = 1e-6
GRAD_RTOL = dryrun.GRAD_RTOL
PARAM_ATOL = 1e-6
ADAM_FLOOR = 1e-6
STATS_ATOL = 1e-6
SPAWN_TIMEOUT = 240  # seconds for the four ranks of the module fixture
SAMPLE_WISE = ModelConfig(sample_wise_bn=True, batch_norm=False)
COMPAT = LossConfig(reference_compat=True)


def _global_batch():
    pts, gt = synthesize_points_batch(np.random.default_rng(1), BATCH, POINTS)
    return {"points": pts, **gt}


def _model(mcfg=ModelConfig(), arrays=None):
    model = FCN(mcfg, image_hw=(SPEC.height, SPEC.width), seed=0)
    if arrays is not None:
        models_io.load_arrays(model, arrays)
    return model


def _run_step(model, batch, step, generator=None) -> dict:
    loss, metrics = step(model, Adam(model.parameters(), 1e-3), batch, generator)
    out = {"loss": loss.numpy(), **{f"metric/{k}": v.numpy() for k, v in metrics.items()}}
    for name, p in model.named_parameters():
        out[f"grad/{name}"] = p.grad.numpy()
        out[f"param/{name}"] = p.detach().numpy()
    out.update({f"buffer/{n}": b.numpy() for n, b in model.named_buffers()})
    return out


# what each rank runs: (model config, loss config, augment, weights from the arrays file)
CASES = {
    "global": (ModelConfig(), LossConfig(), True, False),
    "per_rank_stats": (ModelConfig(), LossConfig(), True, False),  # the fault
    "sample_wise_compat": (SAMPLE_WISE, COMPAT, True, False),
    "reference": (ModelConfig(), LossConfig(), False, True),
}


def _pair_mesh(mesh, n_spatial: int):
    """Ranks 0 and 1 as a mesh of their own, data x 2 (n_spatial 1) or 1 x
    2; None on the other ranks. Every rank creates every group."""
    import torch.distributed as dist

    pair = dist.new_group([0, 1])
    singles = [dist.new_group([r]) for r in (0, 1)]
    if mesh.rank > 1:
        return None
    if n_spatial == 1:
        return Mesh(group=pair, rank=mesh.rank, world_size=2, device=mesh.device, backend=mesh.backend)
    return Mesh(group=pair, rank=mesh.rank, world_size=2, device=mesh.device, backend=mesh.backend,
                axis_names=("data", "spatial"), n_spatial=2, data_group=singles[mesh.rank],
                spatial_group=pair)


def _todays_small_float_path():
    """The data-parallel step as it combined a small float's gradients
    before it followed XLA (the negative control): each rank's loss its
    rows' mean, `average_gradients`' float32 mean of the ranks' rounded
    gradients. Returns a function that restores the step."""
    from tpufusion_torch.parallel.mesh import all_reduce_mean, average_gradients
    from tpufusion_torch.train import train_step

    keep = train_step.weighted_pose_loss, train_step.reduce_gradients, train_step.all_reduce_sum
    train_step.weighted_pose_loss = lambda *a, global_share=False, **kw: keep[0](*a, **kw)
    train_step.reduce_gradients = lambda plan, mesh, fmt: average_gradients([p for p, _ in plan], mesh)
    train_step.all_reduce_sum = all_reduce_mean

    def restore():
        train_step.weighted_pose_loss, train_step.reduce_gradients, train_step.all_reduce_sum = keep
    return restore


# the small-float steps: case -> (mesh: "data2", "spatial2" or "data4", format)
F8_CASES = {"f8_data2": ("data2", "float8_e4m3fn"), "f8_spatial2": ("spatial2", "float8_e4m3fn"),
            "f8_data2_e5m2": ("data2", "float8_e5m2"), "f8_data4": ("data4", "float8_e4m3fn"),
            "f8_data2_today": ("data2", "float8_e4m3fn")}


def _small_float_checks(mesh, outdir):
    meshes = {"data2": _pair_mesh(mesh, 1), "spatial2": _pair_mesh(mesh, 2), "data4": mesh}
    for case, (layout, name) in F8_CASES.items():
        m = meshes[layout]
        if m is None:
            continue
        restore = _todays_small_float_path() if case.endswith("_today") else (lambda: None)
        try:
            out = dryrun.small_float_step(m, name)
        finally:
            restore()
        np.savez(os.path.join(outdir, f"{case}_rank{mesh.rank}.npz"), **out)


def _rank_checks(mesh, outdir):
    """Every rank: the train steps of CASES, the small-float steps, the
    pipelines, the mesh helpers."""
    _small_float_checks(mesh, outdir)
    batch = shard_batch(_global_batch(), mesh)
    arrays = dict(np.load(os.path.join(outdir, "arrays.npz")))
    for case, (mcfg, loss_cfg, augment, from_arrays) in CASES.items():
        model = replicate(_model(mcfg, arrays if from_arrays else None), mesh)
        step = make_train_step(SPEC, loss_cfg, TrainConfig(batch_size=BATCH, augment=augment), mesh=mesh)
        keep = port_fcn.all_reduce_mean
        if case == "per_rank_stats":  # BatchNorm over this rank's rows alone
            port_fcn.all_reduce_mean = lambda x, mesh: x
        try:
            out = _run_step(model, batch, step, torch.Generator().manual_seed(2))
        finally:
            port_fcn.all_reduce_mean = keep
        np.savez(os.path.join(outdir, f"{case}_rank{mesh.rank}.npz"), **out)

    data = {"idx": np.arange(21, dtype=np.int64), "x": np.random.default_rng(0).random((21, 3))}
    for resident in (True, False):
        pipe = BatchPipeline(data, 8, seed=3, sharding=batch_sharding(mesh), device_resident=resident)
        rows = [b["idx"].numpy() for _ in range(2) for b in pipe.epoch()]
        np.save(os.path.join(outdir, f"pipe{int(resident)}_rank{mesh.rank}.npy"), np.stack(rows))

    probe = torch.full((3,), float(mesh.rank))
    replicate([probe], mesh)
    helpers = {
        "axis_names": list(mesh.axis_names), "shape": mesh.shape, "world": mesh.world_size,
        "replicated": probe.tolist(), "rows": [batch_sharding(mesh).rows(BATCH).start,
                                               batch_sharding(mesh).rows(BATCH).stop],
        "image_is_batch": image_sharding(mesh, 3) == batch_sharding(mesh),
        "constrain_is_identity": constrain_spatial(batch["points"], mesh) is batch["points"],
        "replicated_sharding": type(replicated_sharding(mesh)).__name__,
    }
    np.save(os.path.join(outdir, f"helpers_rank{mesh.rank}.npy"), np.array(helpers, dtype=object))


def save_rank_probe(mesh, path):
    """A rank's tensor made on its mesh's device, saved as it is (a rank
    function for `dryrun.spawn` from the other test modules)."""
    torch.save(torch.full((1,), float(mesh.rank), device=mesh.device), path)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ranks"))
    arrays = _reference_arrays()
    np.savez(os.path.join(outdir, "arrays.npz"), **arrays)
    dryrun.spawn(_rank_checks, RANKS, "cpu", args=(outdir,), timeout=SPAWN_TIMEOUT)

    def load(name, rank=0):
        path = os.path.join(outdir, f"{name}_rank{rank}")
        return dict(np.load(path + ".npz")) if os.path.exists(path + ".npz") else np.load(
            path + ".npy", allow_pickle=True)

    return load, arrays


def _reference_arrays():
    from tests.torch_golden import random_arrays

    return random_arrays(FCN(ModelConfig()), seed=5)


def _one_process(case, arrays):
    mcfg, loss_cfg, augment, from_arrays = CASES[case]
    model = _model(mcfg, arrays if from_arrays else None)
    step = make_train_step(SPEC, loss_cfg, TrainConfig(batch_size=BATCH, augment=augment), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _global_batch().items()}
    return _run_step(model, batch, step, torch.Generator().manual_seed(2))


def _readings(got: dict, want: dict) -> dict:
    """The sharded step against one process, in the module docstring's terms."""
    out = {"loss": float(abs(got["loss"] - want["loss"]) / abs(want["loss"])),
           "metrics": max(float(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30))
                          for k in want if k.startswith("metric/"))}
    grads = [k for k in want if k.startswith("grad/")]
    out["grads"] = max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                       for k in grads)
    out["params"] = max(float((np.abs(got[k.replace("grad/", "param/")] - want[k.replace("grad/", "param/")])
                               * (np.abs(want[k]) > ADAM_FLOOR)).max()) for k in grads)
    out["stats"] = max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1.0))
                       for k in want if k.startswith("buffer/"))
    return out


def _within(r: dict) -> bool:
    return (r["loss"] <= LOSS_RTOL and r["metrics"] <= LOSS_RTOL and r["grads"] <= GRAD_RTOL
            and r["params"] <= PARAM_ATOL and r["stats"] <= STATS_ATOL)


@pytest.mark.parametrize("case", ["global", "sample_wise_compat"])
def test_four_rank_step_matches_one_process(case, four_ranks):
    """The roll on: BatchNorm (or SampleWiseBN with the batch-wide
    regression norm of reference_compat) over the global batch, the
    gradients averaged, the global loss and metrics on every rank."""
    load, arrays = four_ranks
    got, want = load(case), _one_process(case, arrays)
    r = _readings(got, want)
    assert _within(r), sorted(r.items())
    for rank in range(1, RANKS):
        other = load(case, rank)
        for k in got:  # one all-reduce: the same averaged gradients, the same step
            np.testing.assert_array_equal(other[k], got[k], err_msg=f"rank {rank}: {k}")


def test_per_rank_batch_statistics_fail_the_check(four_ranks):
    """DDP's BatchNorm (each rank's own rows' statistics) is another model:
    the same comparison reads far outside the limits (gradients 0.17 of
    their largest entries, statistics 1e-2; the loss only 2e-6, so the
    loss alone would not tell), so the check can fail."""
    load, arrays = four_ranks
    r = _readings(load("per_rank_stats"), _one_process("per_rank_stats", arrays))
    assert not _within(r), r
    assert r["grads"] > 50 * GRAD_RTOL and r["stats"] > 100 * STATS_ATOL and r["loss"] > LOSS_RTOL, r


def test_four_rank_step_matches_the_reference_four_device_step(four_ranks):
    """The reference's make_train_step(..., mesh=make_mesh(MeshConfig(
    n_devices=4))) on the same weights and global batch, the roll off: the
    loss, metrics and BatchNorm statistics of its step, and the gradients of
    its loss under the same mesh, within the train golden's limits."""
    import jax
    import optax
    from flax import nnx

    from tests.torch_golden import jax_model_from_arrays, to_jax_config
    from tpufusion.geometry.encoding import encode_label_batch
    from tpufusion.geometry.range_view import range_view_project_batch
    from tpufusion.models.losses import weighted_pose_loss
    from tpufusion.parallel import mesh as jax_mesh
    from tpufusion.train import train_step as jax_train_step
    from tpufusion_torch import _golden

    load, arrays = four_ranks
    got = load("reference")
    jmesh = jax_mesh.make_mesh(to_jax_config(MeshConfig(n_devices=RANKS)))
    jspec, jloss = to_jax_config(SPEC), to_jax_config(LossConfig())
    sh = jax_mesh.batch_sharding(jmesh)
    jbatch = {k: jax.device_put(v, sh) for k, v in _global_batch().items()}

    grad_model = jax_model_from_arrays(ModelConfig(), arrays)
    nnx.update(grad_model, jax_mesh.replicate(nnx.state(grad_model), jmesh))

    @nnx.jit
    def grads_of(m, b):
        images = range_view_project_batch(b["points"], jspec)
        labels = encode_label_batch(b["center"], b["size"], b["yaw"], images, jspec)
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
    worst = max(float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30)) for k, w in flat.items())
    assert worst <= _golden.TRAIN_GRAD_RTOL, worst
    for name in ("mean", "var"):
        np.testing.assert_allclose(got[f"buffer/norm.{name}"], np.asarray(getattr(model.norm, name)[...]),
                                   rtol=0, atol=_golden.TRAIN_STATS_ATOL)


@pytest.mark.parametrize("resident", [True, False], ids=["device_resident", "streamed"])
def test_four_rank_pipeline_yields_the_row_blocks(resident, four_ranks):
    """Every rank draws the one-process epoch plan from the same seed and
    yields its block of rows of each global batch of 8 (21 rows: the last
    batch filled from a second shuffle)."""
    load, _ = four_ranks
    data = {"idx": np.arange(21, dtype=np.int64), "x": np.random.default_rng(0).random((21, 3))}
    pipe = BatchPipeline(data, 8, seed=3, device_resident=resident, device="cpu")
    want = np.stack([b["idx"].numpy() for _ in range(2) for b in pipe.epoch()])  # (6, 8)
    got = np.concatenate([load(f"pipe{int(resident)}", r) for r in range(RANKS)], axis=1)
    np.testing.assert_array_equal(got, want)


def test_mesh_helpers_on_every_rank(four_ranks):
    load, _ = four_ranks
    for rank in range(RANKS):
        h = load("helpers", rank).item()
        assert h["axis_names"] == ["data"] and h["shape"] == {"data": RANKS} and h["world"] == RANKS
        assert h["replicated"] == [0.0, 0.0, 0.0]  # rank 0's values everywhere
        assert h["rows"] == [rank * BATCH // RANKS, (rank + 1) * BATCH // RANKS]
        assert h["image_is_batch"] and h["constrain_is_identity"]
        assert h["replicated_sharding"] == "Replicated"


def test_dryrun_multichip_four_ranks(capsys):
    """The four phases of the dry run on four gloo ranks, laid out as the
    reference's dry run lays out four devices (2 data x 2 spatial): the
    train step, the corner e2e step, the flagship and the flagship at 32 x
    1801, each sharded and held against one process (found equal, poses
    1e-4); with the f8 mesh golden, the train phase's float8_e4m3fn case
    on every rank equal to JAX's same-mesh step."""
    from tests.torch_golden import GOLDEN_F8_MESH

    out = dryrun.dryrun_multichip(4, device="cpu", timeout=SPAWN_TIMEOUT,
                                  small_float_golden=GOLDEN_F8_MESH)
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == out["lines"] and len(printed) == 5
    assert out["mesh"] == {"data": 2, "spatial": 2}
    assert all("{'data': 2, 'spatial': 2}" in line for line in printed)
    for phase in ("corner", "flagship", "full_width"):
        got = out["ranks"][0][phase]
        assert got["found_equal"] and got["pose_abs"] <= dryrun.POSE_ATOL
    assert out["ranks"][0]["full_width"]["found"] > 0
    for rank in out["ranks"]:
        sfr = rank["small_float"]
        assert (sfr["layout"], sfr["same"], sfr["steps"]) == ("2x2", 1.0, 0)
        assert sfr["loss_rel"] <= dryrun.LOSS_RTOL
    # the CPU runs the plain versions
    assert out["launches"] == dict.fromkeys(dryrun.KERNELS + dryrun.SMALL_FLOAT_KERNELS, 0)


def test_spatial_axis_and_wrong_arguments_raise():
    """A spatial axis lays the ranks out as the reference does (rank d at
    data d // n_spatial, spatial d % n_spatial; every rank of a data row
    takes the row's frames and its own block of columns), and a
    n_spatial that does not divide the world raises."""
    spatial = Mesh(group=None, rank=3, world_size=4, device=torch.device("cpu"), backend="gloo",
                   axis_names=("data", "spatial"), n_spatial=2)
    assert spatial.shape == {"data": 2, "spatial": 2}
    assert (spatial.data_index, spatial.spatial_index) == (1, 1)
    assert batch_sharding(spatial).rows(8) == slice(4, 8)
    assert image_sharding(spatial, 4).columns(1801) == slice(901, 1801)
    image = torch.arange(2 * 3 * 201).reshape(2, 3, 201)
    assert torch.equal(constrain_spatial(image, spatial), image[:, :, 101:])
    with pytest.raises(ValueError, match="6 ranks are not divisible by n_spatial=4"):
        make_mesh(MeshConfig(n_devices=6, n_spatial=4), device="cpu")
    mesh = Mesh(group=None, rank=1, world_size=4, device=torch.device("cpu"), backend="gloo")
    assert batch_sharding(mesh).rows(8) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(mesh).rows(6)
    with pytest.raises(ValueError, match="does not split"):
        BatchPipeline({"x": np.zeros((12, 2))}, 6, sharding=batch_sharding(mesh))
    with pytest.raises(TypeError):
        batch_sharding(object())
    sharded = BatchPipeline({"x": np.arange(12.0)}, 8, shuffle=False,
                            sharding=BatchSharding(mesh), device="cuda")
    assert sharded.device == torch.device("cpu")  # the mesh's device, not the argument
    assert [b["x"].tolist() for b in sharded.epoch()] == [[2.0, 3.0], [10.0, 11.0]]


F8_LAYOUTS = {"data2": (2, 1), "spatial2": (2, 2), "data4": (4, 1)}


@pytest.fixture(scope="module")
def golden_f8_mesh():
    from tests.torch_golden import GOLDEN_F8_MESH
    from tpufusion_torch import _golden

    return _golden.load_npz(GOLDEN_F8_MESH)


def _jax_grads(case: str, golden) -> dict:
    """JAX's train step of `case`'s mesh and format: {"loss", "<layer>.<param>"}."""
    from tests.make_torch_port_golden import jax_f8_mesh_step
    from tpufusion_torch import _golden
    from tpufusion_torch.ops.small_float import FORMATS, decode

    layout, name = F8_CASES[case]
    if layout in _golden.F8_MESH_LAYOUTS and name == _golden.F8_MESH_NAME:
        out = {"loss": golden[f"{layout}/loss"]}
        for k, v in golden.items():
            if k.startswith(layout + "/") and not k.endswith("/loss"):
                out[k[len(layout) + 1:].replace("/", ".")] = decode(torch.from_numpy(v),
                                                                    FORMATS[name]).numpy()
        return out
    return {k.replace("/", "."): v for k, v in jax_f8_mesh_step(*F8_LAYOUTS[layout], name).items()}


def _equal_share(got: dict, want: dict) -> dict:
    """Each gradient's share of values equal to JAX's, where not all are
    (NaN equal to NaN)."""
    out = {}
    for k, w in want.items():
        if k == "loss":
            continue
        g = got[f"grad/{k}"]
        same = (g == w) | (np.isnan(g) & np.isnan(w))
        if not same.all():
            out[k] = float(same.mean())
    return out


@pytest.mark.parametrize("case", ["f8_data2", "f8_spatial2", "f8_data2_e5m2", "f8_data4"])
def test_small_float_step_matches_jaxs_same_mesh_step(case, four_ranks, golden_f8_mesh):
    """Every rank of the mesh: the gradients JAX's train step on the same
    mesh takes, bit for bit, and its loss within 1e-5; the ranks' updated
    parameters equal rank 0's."""
    load, _ = four_ranks
    want = _jax_grads(case, golden_f8_mesh)
    ranks = F8_LAYOUTS[F8_CASES[case][0]][0]
    lead = load(case)
    for rank in range(ranks):
        got = load(case, rank)
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))
        assert _equal_share(got, want) == {}, (rank, _equal_share(got, want))
        assert all(np.array_equal(got[k], lead[k]) for k in lead if k.startswith("param/")), rank


def test_todays_data_parallel_path_differs_from_jaxs_step(four_ranks, golden_f8_mesh):
    """The negative control: each rank's gradient rounded over its own rows
    and the ranks' float32 mean leave some gradient of the data x 2 step
    off JAX's, while the path it replaced gives every one."""
    load, _ = four_ranks
    want = _jax_grads("f8_data2", golden_f8_mesh)
    assert _equal_share(load("f8_data2"), want) == {}
    off = _equal_share(load("f8_data2_today"), want)
    assert off and min(off.values()) < 0.999, off


def test_golden_f8_mesh_file_is_current(golden_f8_mesh):
    """The f8 mesh golden equals what JAX's train step computes now on each
    layout (rerun `tests/make_torch_port_golden.py f8_mesh` if not): the
    inputs' digest and every gradient code equal, the loss within 1e-6."""
    from tests.make_torch_port_golden import golden_f8_mesh_arrays

    fresh = golden_f8_mesh_arrays()
    assert sorted(fresh) == sorted(golden_f8_mesh)
    for k, v in fresh.items():
        if k.endswith("/loss"):
            np.testing.assert_allclose(golden_f8_mesh[k], v, rtol=0, atol=1e-6, err_msg=k)
        else:
            assert np.array_equal(golden_f8_mesh[k], v), k
