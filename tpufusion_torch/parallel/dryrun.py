"""The multi-rank dry run (counterpart of `__graft_entry__.dryrun_multichip`).

    from tpufusion_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")             # 2 data x 2 spatial gloo ranks on the CPU
    dryrun_multichip(2, device="cuda:0", backend="gloo")  # two data ranks, one card
    dryrun_multichip(2, device="cuda:0", backend="gloo",
                     mesh_cfg=MeshConfig(n_devices=2, n_spatial=2))  # 1 x 2 spatial

`dryrun_multichip(n)` spawns n ranks (start method "spawn": CUDA cannot be
forked once initialized) and lays them out as the reference does: a data
x spatial mesh with two spatial ranks when n >= 4 and n is even, else
data only (`__graft_entry__.py`'s rule; a `MeshConfig` picks another
layout). It runs four phases over the mesh, each held against one process
on the same global batch (rank 0 runs that process's answer itself):

  1. the full train step (projection, label encode, roll, forward,
     backward, gradient all-reduce, Adam) of the default FCN, at `spec`
     (width 201 unless the caller gives another) on 2n uniform clouds (2
     frames a rank unless the caller gives another number):
     the loss, the metrics, the averaged gradients, the updated
     parameters and the BatchNorm statistics, and every rank's
     parameters equal to rank 0's;
  2. the corner e2e step (projection + FCN + `decode_batch`);
  3. the flagship direct step (direct head, width 2, `decode_batch_direct`);
  4. the flagship at the full 32 x 1801 geometry, one frame a rank;
  and, given the f8 mesh golden (`small_float_golden`), the train
  phase's float8_e4m3fn case: the golden's step on this mesh
  (`small_float_step`), held to JAX's same-mesh step.

Each data row projects its frames at full width; on a spatial mesh the
image and labels are cut to each rank's columns, the FCN runs
width-sharded with halo exchanges (`parallel/halo.py`), and in phases 2-4
its maps are gathered back to the whole width for the decode. The sharded
poses come back with `all_gather`: `found` must be equal and the poses
within 1e-4, the reference's own limit, and the ranks of a data row must
return the same poses. On the card every rank also holds both kernels
against their plain versions on its own points and heat masks, and its
kernel launches come back to the caller. It prints one line a phase,
naming the mesh as the reference prints it, and returns a summary dict.

`spawn` is the launcher underneath: it runs a function on every rank of
a fresh process group and raises if a rank fails or the time runs out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpufusion_torch.config import DecodeConfig, LossConfig, MeshConfig, ModelConfig, RangeViewSpec, TrainConfig
from tpufusion_torch.parallel.halo import fetch_columns
from tpufusion_torch.parallel.mesh import (
    all_gather_columns,
    all_gather_rows,
    average_gradients,
    constrain_spatial,
    free_port,
    make_mesh,
    replicate,
    shard_batch,
)

POSE_ATOL = 1e-4  # sharded poses against one process (__graft_entry__.py's limit)
LOSS_RTOL = 1e-5  # the sharded step's loss against one process, relative
# averaged gradients against one process, of each tensor's largest entry.
# A rank's batch is a fraction of one process's, so the gradient sums run
# in another order, and on the card cuDNN also picks its algorithms by
# batch size. The worst tensor is the regression head's deconv5b kernel,
# whose entries are sums that cancel to ~1e-6 on a fresh init: it reads
# 4e-6 to 2e-4 on the CPU (4 ranks; more where torch runs one thread) and
# 5.8e-4 on an H100 (2 ranks at 32 x 1801), where the same one-process
# step twice reads 3e-7.
# A fault reads far above: per-rank BatchNorm statistics 0.17, gradients
# summed and not averaged 1.0.
GRAD_RTOL = 2e-3
PARAM_ATOL = 1e-5  # parameters after the step (tests/test_multichip.py's limit), where |g| > ADAM_FLOOR
ADAM_FLOOR = 1e-6
# BatchNorm running statistics after the step, of each buffer's largest
# entry (absolute below 1): the range channel's variance reaches ~10
STATS_RTOL = 1e-6
SWEEP_CAP = 16384  # plain CC sweeps when a rank holds the kernel against them
KERNELS = ("project_points", "nearest_wins_image", "connected_components_with_bbox", "corner_vote")
# the small-float step's kernels (`small_float_phase`), by chip_smoke.py's names
SMALL_FLOAT_KERNELS = ("small_float", "small_float_cast", "small_float_backward",
                       "small_float_reduce")
# the small-float step's loss against the golden's, relative: the card's
# float16 convolutions and cuDNN's sums move some outputs a format step.
# An H100 read 9e-8 and 2e-7 (data x 2, 1 x 2; PERF.md), the CPU less.
SMALL_FLOAT_LOSS_RTOL = 1e-6


def _entry(rank: int, fn, n: int, port: int, device: str, backend: str | None, args: tuple,
           mesh_cfg: MeshConfig):
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False  # float32 parity, as the goldens run
        torch.set_float32_matmul_precision("highest")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank, timeout=timedelta(seconds=300))
    try:
        fn(make_mesh(mesh_cfg, device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, device: torch.device | str = "cuda", backend: str | None = None,
          args: tuple = (), timeout: float = 600.0, mesh_cfg: MeshConfig | None = None) -> None:
    """Runs fn(mesh, *args) on n spawned ranks of a new process group on
    a free localhost port (NCCL on the card unless `backend` says
    otherwise, gloo on the CPU), the mesh made from `mesh_cfg` (default:
    n data ranks). `device` "cuda" gives each rank its card,
    "cuda:0" puts every rank on card 0, "cpu" runs on the CPU. Returns when
    every rank has returned; raises if one raises (the others are stopped)
    or after `timeout` seconds (all are killed). `fn` must be a
    module-level function."""
    if torch.device(device).type == "cuda":
        torch.empty(0, device=device)  # without a card, raise here, not in the ranks
    mesh_cfg = mesh_cfg or MeshConfig(n_devices=n)
    ctx = mp.start_processes(_entry, args=(fn, n, free_port(), str(device), backend, args, mesh_cfg),
                             nprocs=n, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} ranks did not finish within {timeout:.0f} s")


def _reset_launches() -> None:
    from tpufusion_torch.ops import cc, corner_vote, pixels, projection

    pixels.LAUNCHES = projection.LAUNCHES = cc.LAUNCHES = corner_vote.LAUNCHES = 0


def _launches() -> dict[str, int]:
    from tpufusion_torch.ops import cc, corner_vote, pixels, projection

    return {"project_points": pixels.LAUNCHES, "nearest_wins_image": projection.LAUNCHES,
            "connected_components_with_bbox": cc.LAUNCHES, "corner_vote": corner_vote.LAUNCHES}


def _hold_kernels(points, spec, heat=None) -> dict:
    """The kernels against their plain versions on this rank's own points
    (and heat masks): {"pixels_equal" (bit for bit the plain version on
    the CPU), "zbuffer_equal", "cc_equal", "cc_sweeps"}. On the CPU the
    wrappers are the plain versions: nothing to hold."""
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys
    from tpufusion_torch.ops import cc, components, pixels, projection

    if points.device.type != "cuda":
        return {}
    with torch.inference_mode():
        args = _frame_pixels_keys(points, spec, None)
        want = pixels.project_points_reference(points.float().cpu(), None, spec)
        same = [torch.equal(a.cpu().view(torch.int32) if a.dtype == torch.float32 else a.cpu(),
                            w.view(torch.int32) if w.dtype == torch.float32 else w)
                for a, w in zip(args, want)]
        out = {"pixels_equal": all(same),
               "zbuffer_equal": bool(torch.equal(projection.nearest_wins_image(*args, spec),
                                                 projection.nearest_wins_image_reference(*args, spec)))}
        if heat is not None:
            heat = heat.contiguous()
            got = cc.connected_components_with_bbox(heat)
            _, sweeps = components.propagate(components.init_state(heat), heat, SWEEP_CAP)
            want = components.connected_components_with_bbox(heat, SWEEP_CAP)
            out["cc_equal"] = bool(torch.equal(got[0], want[0]) and all(
                torch.equal(g[heat], w[heat]) for g, w in zip(got[1:], want[1:])))
            out["cc_sweeps"] = int(sweeps.max())
            assert out["cc_sweeps"] < SWEEP_CAP, "plain CC sweeps did not converge"
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _train_phase(mesh, spec: RangeViewSpec, frames: int, n_points: int, timed_steps: int) -> dict:
    from tpufusion_torch.data.synthetic import synthesize_points_batch
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    dev, batch = mesh.device, frames * mesh.world_size
    pts, gt = synthesize_points_batch(np.random.default_rng(1), batch, n_points)
    global_batch = {"points": pts, **gt}
    tcfg = TrainConfig(batch_size=batch)  # the roll on, as the trainer runs it

    def setup():
        model = FCN(ModelConfig(), in_channels=3, seed=0).to(dev)
        return model, Adam(model.parameters(), 1e-3), torch.Generator(device=dev).manual_seed(2)

    model, opt, gen = setup()
    replicate(model, mesh)
    step = make_train_step(spec, LossConfig(), tcfg, mesh=mesh)
    local = shard_batch(global_batch, mesh)
    _reset_launches()
    mesh.halo.reset()
    mesh.halo.keep = True  # the step's exchanges, replayed alone below
    loss, metrics = step(model, opt, local, gen)
    _sync(dev)
    mesh.halo.keep = False
    out = {"launches": _launches(), "loss": float(loss),
           "kernels": _hold_kernels(local["points"], spec),
           "halo": {"calls": mesh.halo.calls, "columns": mesh.halo.columns,
                    "grad_columns": mesh.halo.grad_columns, "records": list(mesh.halo.records)}}
    flat = torch.cat([t.detach().reshape(-1) for t in (*model.parameters(), *model.buffers())])
    rank0 = flat.clone()
    dist.broadcast(rank0, src=0, group=mesh.group)
    out["replica_max_diff"] = float((flat - rank0).abs().max())
    if mesh.rank == 0:  # one process, the whole batch (twice: the card's own spread)
        full = {k: torch.from_numpy(v).to(dev) for k, v in global_batch.items()}
        m1, o1, g1 = setup()
        loss1, metrics1 = make_train_step(spec, LossConfig(), tcfg, device=dev)(m1, o1, full, g1)
        m2, o2, g2 = setup()
        make_train_step(spec, LossConfig(), tcfg, device=dev)(m2, o2, full, g2)
        out["loss_rel"] = abs(float(loss) - float(loss1)) / abs(float(loss1))
        out["metrics_rel"] = max(abs(float(metrics[k]) - float(metrics1[k])) / max(abs(float(metrics1[k])), 1e-30)
                                 for k in metrics1)
        pairs = [(a.detach(), b.detach(), b.grad) for a, b in zip(model.parameters(), m1.parameters())]
        rel = _grad_rel(model, m1)
        out["grad_rel"] = max(rel.values())
        out["grad_worst"] = sorted(rel, key=rel.get)[-3:]
        out["grad_rel_repeat"] = max(_grad_rel(m2, m1).values())
        # Adam's first update is lr g / (|g| + 1e-8): where |g| nears that
        # epsilon, last-bit differences of g move it by up to lr
        out["param_abs"] = max(float(((a - b).abs() * (g.abs() > ADAM_FLOOR)).max())
                               for a, b, g in pairs)
        out["param_abs_all"] = max(float((a - b).abs().max()) for a, b, _ in pairs)
        out["stats_rel"] = max(float((a - b).abs().max() / b.abs().max().clamp(min=1.0))
                               for a, b in zip(model.buffers(), m1.buffers()))
    if timed_steps:
        out["ms_per_step"] = _time(lambda: step(model, opt, local, gen), timed_steps, dev)
        out["allreduce_ms"] = _time(lambda: average_gradients(model.parameters(), mesh), timed_steps, dev)
        if mesh.n_spatial > 1:
            out["halo_ms"] = _time(lambda: _replay_halo(mesh, out["halo"]["records"]), timed_steps, dev)
        dist.barrier(group=mesh.group)
        if mesh.rank == 0:
            full = {k: torch.from_numpy(v).to(dev) for k, v in global_batch.items()}
            plain = make_train_step(spec, LossConfig(), tcfg, device=dev)
            out["one_process_ms_per_step"] = _time(lambda: plain(m1, o1, full, g1), timed_steps, dev)
        dist.barrier(group=mesh.group)
    return out


def small_float_step(mesh, name: str | None = None, norm: bool = False, lr: float = 1e-3,
                     timed_steps: int = 0) -> dict:
    """The f8 mesh golden's train step (`_golden.py`, F8_MESH_*) on this
    rank: the flagship FCN in `name` (default F8_MESH_NAME) with or
    without its input norm, the weights of its seed, this rank's share of
    the golden's inputs -> {"loss", "grad/<param>" (after the mesh's
    combine), "param/<param>" (after the port's Adam at `lr`)} as numpy.
    `timed_steps` > 0 then times that many more steps on the same batch
    ("ms_per_step", host clock, the device synchronized)."""
    from tpufusion_torch._golden import F8_GRAD_LOSS, F8_MESH_SEED, f8_mesh_config, f8_mesh_inputs
    from tpufusion_torch.models.fcn import FCN
    from tpufusion_torch.train.optim import Adam
    from tpufusion_torch.train.train_step import make_train_step

    images, labels = f8_mesh_inputs()
    model = replicate(FCN(f8_mesh_config(*((name,) if name else ()), norm=norm),
                          seed=F8_MESH_SEED).to(mesh.device), mesh)
    step = make_train_step(RangeViewSpec(res_h_deg=1.8), LossConfig(**F8_GRAD_LOSS),
                           TrainConfig(augment=False), mesh=mesh, head="direct")
    opt, batch = Adam(model.parameters(), lr), shard_batch({"images": images, "labels": labels}, mesh)
    loss, _ = step(model, opt, batch)
    out = {"loss": loss.cpu().numpy()}
    for n, p in model.named_parameters():
        out[f"grad/{n}"] = p.grad.cpu().numpy()
        out[f"param/{n}"] = p.detach().cpu().numpy()
    if timed_steps:
        out["ms_per_step"] = _time(lambda: step(model, opt, batch), timed_steps, mesh.device)
    return out


def small_float_phase(mesh, golden_path: str, timed_steps: int = 0) -> dict:
    """`small_float_step` on this rank, its kernels' launches counted,
    against the f8 mesh golden's layout of this mesh (F8_MESH_LAYOUTS):
    {"launches", "layout", "loss", `f8_mesh_readings`' keys}; with
    `timed_steps`, "ms_per_step" as `small_float_step`'s."""
    from tpufusion_torch._golden import F8_MESH_LAYOUTS, f8_mesh_readings, load_npz
    from tpufusion_torch.ops import small_float as sf

    layouts = {v: k for k, v in F8_MESH_LAYOUTS.items()}
    layout = layouts.get((mesh.world_size, mesh.n_spatial))
    if layout is None:
        raise ValueError(f"the f8 mesh golden has no {mesh.shape} layout: {F8_MESH_LAYOUTS}")
    sf.LAUNCHES = sf.CAST_LAUNCHES = sf.BACKWARD_LAUNCHES = sf.REDUCE_LAUNCHES = 0
    got = small_float_step(mesh)
    _sync(mesh.device)
    launches = {"small_float": sf.LAUNCHES, "small_float_cast": sf.CAST_LAUNCHES,
                "small_float_backward": sf.BACKWARD_LAUNCHES,
                "small_float_reduce": sf.REDUCE_LAUNCHES}
    grads = {k[5:]: v for k, v in got.items() if k.startswith("grad/")}
    readings = f8_mesh_readings(grads, float(got["loss"]), load_npz(golden_path), layout)
    res = {"launches": launches, "layout": layout, "loss": float(got["loss"]), **readings}
    if timed_steps:
        res["ms_per_step"] = float(small_float_step(mesh, timed_steps=timed_steps)["ms_per_step"])
    return res


def _replay_halo(mesh, records) -> None:
    """A step's halo exchanges alone, forward and backward, on tensors of
    the shapes the step exchanged."""
    for r in records:
        x = torch.ones(r["shape"], dtype=getattr(torch, r["dtype"]), device=mesh.device,
                       requires_grad=True)
        y = fetch_columns(x, mesh, r["width"], r["windows"])
        y.backward(torch.ones_like(y))


def _grad_rel(a, b) -> dict[str, float]:
    """Each parameter's gradient in `a` against `b`'s, relative to b's
    largest entry."""
    return {n: float((p.grad - q.grad).abs().max() / q.grad.abs().max().clamp(min=1e-30))
            for (n, p), q in zip(a.named_parameters(), b.parameters())}


def _time(fn, reps: int, dev) -> float:
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _e2e_phase(mesh, model, spec: RangeViewSpec, head: str, pts: np.ndarray, dcfg: DecodeConfig) -> dict:
    from tpufusion_torch.decode.decode import heat_mask
    from tpufusion_torch.predict import make_e2e_step

    dev = mesh.device
    step = make_e2e_step(model, spec, dcfg, head=head, mesh=mesh)
    local = shard_batch({"points": pts}, mesh)["points"]
    _reset_launches()
    poses, found = step(local)
    _sync(dev)
    out = {"launches": _launches(), "local_poses": poses.tolist(), "local_found": found.tolist()}
    with torch.inference_mode():
        from tpufusion_torch.geometry.range_view import range_view_project_batch

        images = range_view_project_batch(local, spec)
        preds = all_gather_columns(model(constrain_spatial(images, mesh), mesh=mesh, width=spec.width),
                                   mesh, spec.width)
        heat = heat_mask(preds[..., 1], dcfg)
        out["kernels"] = _hold_kernels(local, spec, heat)
        poses, found = all_gather_rows(poses, mesh), all_gather_rows(found, mesh)
        preds = all_gather_rows(preds, mesh)
        if mesh.rank == 0:
            full = torch.from_numpy(pts).to(dev)
            ref_poses, ref_found = make_e2e_step(model, spec, dcfg, head=head, device=dev)(full)
            per_frame = (poses - ref_poses).abs().amax(dim=-1)
            out["found_equal"] = bool(torch.equal(found, ref_found))
            out["found"] = int(found.sum())
            out["pose_abs"] = float(per_frame.max())
            out["frames_over"] = int((per_frame > POSE_ATOL).sum())
            # the FCN's maps the decode read, against one process's
            out["maps_abs"] = float((preds - model(range_view_project_batch(full, spec))).abs().max())
    return out


def _rank_phases(mesh, spec: RangeViewSpec, frames: int, n_points: int, full_points: int,
                 timed_steps: int, outdir: str, small_float_golden: str | None = None) -> None:
    from tpufusion_torch.data.synthetic import synthesize_points_batch
    from tpufusion_torch.models.fcn import FCN

    dev, n = mesh.device, mesh.world_size
    res = {"train": _train_phase(mesh, spec, frames, n_points, timed_steps)}
    if small_float_golden:
        res["small_float"] = small_float_phase(mesh, small_float_golden, timed_steps)
    pts, _ = synthesize_points_batch(np.random.default_rng(1), frames * n, n_points)
    corner = FCN(ModelConfig(), in_channels=3, seed=0).to(dev)
    res["corner"] = _e2e_phase(mesh, replicate(corner, mesh), spec, "corner", pts, DecodeConfig())
    flagship_cfg = dataclasses.replace(ModelConfig(), head="direct", width_multiplier=2,
                                       reg_output_activation="linear")
    flagship = replicate(FCN(flagship_cfg, in_channels=3, seed=0).to(dev), mesh)
    res["flagship"] = _e2e_phase(mesh, flagship, spec, "direct", pts, DecodeConfig())
    fpts, _ = synthesize_points_batch(np.random.default_rng(4), n, full_points)
    res["full_width"] = _e2e_phase(mesh, flagship, RangeViewSpec(), "direct", fpts,
                                   DecodeConfig(min_bbox_area=20.0))
    with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(res, f)


def _fcn_rank(mesh, cases: dict, width: int, frames: int, outdir: str) -> None:
    from tpufusion_torch.models.fcn import FCN

    rng = np.random.default_rng(5)
    x = np.stack([rng.uniform(0, 90, (frames, 32, width)), rng.uniform(-2, 2, (frames, 32, width)),
                  rng.uniform(0, 100, (frames, 32, width))], axis=-1).astype(np.float32)
    x = torch.from_numpy(x).to(mesh.device)
    out = {}
    for name, mcfg in cases.items():
        model = FCN(mcfg, seed=0).to(mesh.device).eval()
        with torch.inference_mode():
            mesh.halo.reset()
            got = all_gather_columns(model(constrain_spatial(x, mesh), mesh=mesh, width=width), mesh, width)
            read = {"halo_calls": mesh.halo.calls, "halo_columns": mesh.halo.columns}
            if mesh.rank == 0:
                want = model(x)
                dp = (got[..., :2] - want[..., :2]).abs()
                dr = (got[..., 2:] - want[..., 2:]).abs()
                read.update(prob_abs=float(dp.max()), reg_abs=float(dr.max()),
                            rel=float((got - want).abs().max() / want.abs().max()),
                            reg_differ_share=float((dr > 0).float().mean()), finite=bool(got.isfinite().all()))
        out[name] = read
    with open(os.path.join(outdir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_fcn_readings(n_spatial: int, cases: dict, device: torch.device | str = "cuda",
                         backend: str | None = None, width: int = 1801, frames: int = 2,
                         timeout: float = 300.0) -> dict:
    """Each FCN of `cases` ({name: ModelConfig}, weights from seed 0) on a 1
    x n_spatial mesh against the unsharded FCN on rank 0's device, on
    `frames` seeded range-view-scale images of 32 x `width`: per case the
    largest probability and regression differences, the largest relative
    to the output's largest entry, the share of regression outputs that
    differ at all, and each rank's halo calls and columns received."""
    with tempfile.TemporaryDirectory() as outdir:
        spawn(_fcn_rank, n_spatial, device, backend, (cases, width, frames, outdir), timeout,
              MeshConfig(n_devices=n_spatial, n_spatial=n_spatial))
        ranks = []
        for r in range(n_spatial):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    return {name: {**ranks[0][name], "ranks_halo": [[r[name]["halo_calls"], r[name]["halo_columns"]] for r in ranks]}
            for name in cases}


def mesh_shape(cfg: MeshConfig) -> dict[str, int]:
    """The mesh's axes and sizes as the reference prints them."""
    k = cfg.n_spatial
    return {cfg.data_axis: cfg.n_devices // k, cfg.spatial_axis: k} if k > 1 else {cfg.data_axis: cfg.n_devices}


def dryrun_multichip(
    n_devices: int,
    device: torch.device | str = "cuda",
    backend: str | None = None,
    spec: RangeViewSpec = RangeViewSpec(res_h_deg=1.8),
    frames_per_rank: int = 2,
    n_points: int = 512,
    full_points: int = 4096,
    timed_steps: int = 0,
    timeout: float = 900.0,
    mesh_cfg: MeshConfig | None = None,
    small_float_golden: str | None = None,
) -> dict:
    """Runs the four phases of the module docstring on `n_devices` ranks
    and asserts each against one process. The mesh is `mesh_cfg`, by
    default the reference's: 2 spatial ranks when n_devices >= 4 and even.
    `device` "cuda" gives each rank
    its card; "cuda:0" with backend="gloo" puts every rank on card 0;
    "cpu" runs gloo ranks on the CPU. Phases 1-3 run `spec` on
    `frames_per_rank` * n frames of `n_points` points, phase 4 the full geometry on n frames of
    `full_points`. `timed_steps` > 0 also times the sharded train step,
    its gradient all-reduce alone, on a spatial mesh its halo exchanges
    alone (forward and backward), and, on rank 0, the one-process step on
    the global batch (host clock, the card synchronized).
    `small_float_golden` (the path of tests/data/torch_port_golden_f8_mesh.npz)
    adds the train phase's float8_e4m3fn case (`small_float_phase`): the
    golden's step on this mesh, every rank's gradients equal to JAX's
    same-mesh step (on the CPU every value; on the card, whose cuDNN
    dgrads sum in another order than XLA, F8_GRAD_SAME of each tensor's
    values and none more than F8_GRAD_STEPS step of the format off:
    `_golden.py`), the loss within SMALL_FLOAT_LOSS_RTOL; with
    `timed_steps`, that step timed too.
    Returns {"mesh", "lines", "launches" (each kernel's launches summed
    over the ranks' sharded calls), "ranks" (each rank's readings)}."""
    device = torch.device(device)
    if device.type == "cuda":
        from tpufusion_torch import _build

        torch.empty(0, device=device)  # without a card, raise here
        _build.load()  # build the kernels once, before the ranks load them
    if mesh_cfg is None:  # __graft_entry__.py's rule
        mesh_cfg = MeshConfig(n_devices=n_devices,
                              n_spatial=2 if (n_devices >= 4 and n_devices % 2 == 0) else 1)
    mesh_cfg = dataclasses.replace(mesh_cfg, n_devices=n_devices)
    n_spatial = mesh_cfg.n_spatial
    shape = mesh_shape(mesh_cfg)
    with tempfile.TemporaryDirectory() as outdir:
        spawn(_rank_phases, n_devices, device, backend,
              (spec, frames_per_rank, n_points, full_points, timed_steps, outdir,
               small_float_golden), timeout, mesh_cfg)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    lead = ranks[0]
    train = lead["train"]
    failures = []

    def hold(ok: bool, what: str) -> bool:
        if not ok:
            failures.append(what)
        return ok

    held = all([
        hold(bool(np.isfinite(train["loss"])), f"train: non-finite loss {train['loss']}"),
        hold(train["loss_rel"] <= LOSS_RTOL, f"train: sharded loss off by {train['loss_rel']:.3e}"),
        hold(train["metrics_rel"] <= LOSS_RTOL, f"train: sharded metrics off by {train['metrics_rel']:.3e}"),
        hold(train["grad_rel"] <= GRAD_RTOL, f"train: sharded gradients off by {train['grad_rel']:.3e}"),
        hold(train["param_abs"] <= PARAM_ATOL, f"train: sharded parameters off by {train['param_abs']:.3e}"),
        hold(train["stats_rel"] <= STATS_RTOL, f"train: BatchNorm statistics off by {train['stats_rel']:.3e}"),
        hold(all(r["train"]["replica_max_diff"] == 0.0 for r in ranks), "train: the replicas drifted apart"),
    ])
    times = ""
    if timed_steps:
        times = (f"; sharded step {train['ms_per_step']:.3f} ms vs one process {train['one_process_ms_per_step']:.3f} "
                 f"ms, the gradient all-reduce alone {train['allreduce_ms']:.3f} ms"
                 + (f", the halo exchanges alone {train['halo_ms']:.3f} ms" if "halo_ms" in train else "")
                 + f" (host clock, {timed_steps} steps)")
    lines = [
        f"dryrun_multichip train-step {'ok' if held else 'FAILED'}: {n_devices} devices (mesh {shape}), batch "
        f"{frames_per_rank * n_devices}, loss {train['loss']:.4f}; against one process: loss {train['loss_rel']:.2e} "
        f"relative, gradients {train['grad_rel']:.2e} of each tensor's largest entry (worst "
        f"{train['grad_worst'][-1]}; the one-process step twice {train['grad_rel_repeat']:.2e}), parameters "
        f"{train['param_abs']:.2e} where |g| > {ADAM_FLOOR:.0e} ({train['param_abs_all']:.2e} "
        f"anywhere), BatchNorm statistics {train['stats_rel']:.2e}, metrics {train['metrics_rel']:.2e} relative"
        f"{times}"]
    names = {"corner": "e2e-inference (projection+FCN+corner decode)",
             "flagship": "flagship (direct head, width 2)",
             "full_width": "full-width flagship (32x1801)"}
    for phase, what in names.items():
        got = lead[phase]
        held = all([
            hold(got["found_equal"], f"{phase}: found differs from one process"),
            hold(got["pose_abs"] <= POSE_ATOL, f"{phase}: poses off by {got['pose_abs']:.3e} in "
                 f"{got['frames_over']} frames"),
            # the ranks of a data row decode the same frames
            hold(all((rank[phase]["local_poses"], rank[phase]["local_found"]) == (
                ranks[r - r % n_spatial][phase]["local_poses"], ranks[r - r % n_spatial][phase]["local_found"])
                for r, rank in enumerate(ranks)), f"{phase}: a rank differs from its data row"),
        ])
        lines.append(f"dryrun_multichip {phase} {'ok' if held else 'FAILED'}: {what} sharded over {shape}, "
                     f"poses match one process within {got['pose_abs']:.2e} ({got['frames_over']} frames over "
                     f"{POSE_ATOL:.0e}; found {got['found']}); the FCN's maps within {got['maps_abs']:.2e}")
    if small_float_golden:
        from tpufusion_torch._golden import F8_GRAD_SAME, F8_GRAD_STEPS, F8_MESH_NAME

        sfs = [r["small_float"] for r in ranks]
        worst = min(sfs, key=lambda x: x["same"])
        same, steps = worst["same"], max(x["steps"] for x in sfs)
        loss_rel = max(x["loss_rel"] for x in sfs)
        exact = same == 1.0 and steps == 0
        held = all([
            hold(exact or (device.type == "cuda" and same >= F8_GRAD_SAME
                           and steps <= F8_GRAD_STEPS),
                 f"small_float: gradients off JAX's same-mesh step ({same:.4%} of "
                 f"{worst['worst']} equal, {steps} steps)"),
            hold(loss_rel <= SMALL_FLOAT_LOSS_RTOL, f"small_float: loss off by {loss_rel:.3e}"),
            hold(all(x["launches"]["small_float_reduce"] > 0 for x in sfs),
                 "small_float: a rank never reduced a bias gradient in the kernel")
            if device.type == "cuda" else True])
        lines.append(f"dryrun_multichip small-float {'ok' if held else 'FAILED'}: the f8 mesh golden's "
                     f"{F8_MESH_NAME} step (layout {sfs[0]['layout']}) over {shape}; every rank's "
                     f"gradients against JAX's same-mesh step: at least {same:.4%} of each tensor "
                     f"equal (the least: {worst['worst']}), at most {steps} steps of the format "
                     f"off; loss within {loss_rel:.2e}"
                     + (f"; {timed_steps} more steps {sfs[0]['ms_per_step']:.3f} ms a step (host "
                        "clock)" if timed_steps else ""))
    launches = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        for phase in ("train", *names):
            for name, v in r[phase]["launches"].items():
                launches[name] += v
            bad = [name for name, v in r[phase]["kernels"].items() if name.endswith("equal") and not v]
            hold(not bad, f"{phase}: {bad} differ from the plain versions")
        for name, v in r.get("small_float", {}).get("launches", {}).items():
            launches[name] = launches.get(name, 0) + v
    for line in lines:
        print(line, flush=True)
    if failures:
        raise AssertionError("dryrun_multichip: " + "; ".join(failures))
    return {"mesh": shape, "lines": lines, "launches": launches, "ranks": ranks}


def main(argv=None) -> None:
    """python -m tpufusion_torch.parallel.dryrun [--ranks N] [--device cuda]
    [--backend nccl|gloo] [--full-geometry] [--frames-per-rank F]
    [--timed-steps K]: the dry run on N ranks (default: every card), its
    phase lines, then one JSON line with the launches and rank 0's train
    readings and times."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    ap.add_argument("--full-geometry", action="store_true",
                    help="32 x 1801 and 32,768 points a frame in every phase")
    ap.add_argument("--frames-per-rank", type=int, default=2)
    ap.add_argument("--timed-steps", type=int, default=0)
    args = ap.parse_args(argv)
    ranks = args.ranks or max(torch.cuda.device_count(), 1)
    geometry = dict(spec=RangeViewSpec(), n_points=32768, full_points=32768) if args.full_geometry else {}
    out = dryrun_multichip(ranks, args.device, args.backend, frames_per_rank=args.frames_per_rank,
                           timed_steps=args.timed_steps, **geometry)
    print(json.dumps({"mesh": out["mesh"], "launches": out["launches"], "train": out["ranks"][0]["train"]}))


if __name__ == "__main__":
    main()
