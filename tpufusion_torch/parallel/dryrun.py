"""The data-parallel dry run (counterpart of `__graft_entry__.dryrun_multichip`).

    from tpufusion_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(4, device="cpu")             # four gloo ranks on the CPU
    dryrun_multichip(2, device="cuda:0", backend="gloo")  # two ranks, one card

`dryrun_multichip(n)` spawns n ranks (start method "spawn": CUDA cannot be
forked once initialized) and runs four phases over a data-parallel mesh,
each held against one process on the same global batch (rank 0 runs that
process's answer itself):

  1. the full train step (projection, label encode, roll, forward,
     backward, gradient all-reduce, Adam) of the default FCN, at `spec`
     (width 201 unless the caller gives another) on 2n uniform clouds (2
     frames a rank unless the caller gives another number):
     the loss, the metrics, the averaged gradients, the updated
     parameters and the BatchNorm statistics, and every rank's
     parameters equal to rank 0's;
  2. the corner e2e step (projection + FCN + `decode_batch`);
  3. the flagship direct step (direct head, width 2, `decode_batch_direct`);
  4. the flagship at the full 32 x 1801 geometry, one frame a rank.

The sharded poses come back with `all_gather`: `found` must be equal and
the poses within 1e-4, the reference's own limit. On the card every rank
also holds both kernels against their plain versions on its own points
and heat masks, and its kernel launches come back to the caller. It
prints one line a phase, naming the mesh, and returns a summary dict.

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
from tpufusion_torch.parallel.mesh import (
    all_gather_rows,
    average_gradients,
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
KERNELS = ("nearest_wins_image", "connected_components_with_bbox")


def _entry(rank: int, fn, n: int, port: int, device: str, backend: str | None, args: tuple):
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    if torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False  # float32 parity, as the goldens run
        torch.set_float32_matmul_precision("highest")
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank, timeout=timedelta(seconds=300))
    try:
        fn(make_mesh(MeshConfig(n_devices=n), device), *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n: int, device: torch.device | str = "cuda", backend: str | None = None,
          args: tuple = (), timeout: float = 600.0) -> None:
    """Runs fn(mesh, *args) on n spawned ranks of a new process group on
    a free localhost port (NCCL on the card unless `backend` says
    otherwise, gloo on the CPU). `device` "cuda" gives each rank its card,
    "cuda:0" puts every rank on card 0, "cpu" runs on the CPU. Returns when
    every rank has returned; raises if one raises (the others are stopped)
    or after `timeout` seconds (all are killed). `fn` must be a
    module-level function."""
    if torch.device(device).type == "cuda":
        torch.empty(0, device=device)  # without a card, raise here, not in the ranks
    ctx = mp.start_processes(_entry, args=(fn, n, free_port(), str(device), backend, args),
                             nprocs=n, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n} ranks did not finish within {timeout:.0f} s")


def _reset_launches() -> None:
    from tpufusion_torch.ops import cc, projection

    projection.LAUNCHES = 0
    cc.LAUNCHES = 0


def _launches() -> dict[str, int]:
    from tpufusion_torch.ops import cc, projection

    return {"nearest_wins_image": projection.LAUNCHES, "connected_components_with_bbox": cc.LAUNCHES}


def _hold_kernels(points, spec, heat=None) -> dict:
    """Both kernels against their plain versions on this rank's own points
    (and heat masks): {"zbuffer_equal", "cc_equal", "cc_sweeps"}. On the
    CPU the wrappers are the plain versions: nothing to hold."""
    from tpufusion_torch.geometry.range_view import _frame_pixels_keys
    from tpufusion_torch.ops import cc, components, projection

    if points.device.type != "cuda":
        return {}
    with torch.inference_mode():
        args = _frame_pixels_keys(points, spec, None)
        out = {"zbuffer_equal": bool(torch.equal(projection.nearest_wins_image(*args, spec),
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
    loss, metrics = step(model, opt, local, gen)
    _sync(dev)
    out = {"launches": _launches(), "loss": float(loss),
           "kernels": _hold_kernels(local["points"], spec)}
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
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
        dist.barrier(group=mesh.group)
        if mesh.rank == 0:
            full = {k: torch.from_numpy(v).to(dev) for k, v in global_batch.items()}
            plain = make_train_step(spec, LossConfig(), tcfg, device=dev)
            out["one_process_ms_per_step"] = _time(lambda: plain(m1, o1, full, g1), timed_steps, dev)
        dist.barrier(group=mesh.group)
    return out


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
    step = make_e2e_step(model, spec, dcfg, head=head, device=dev)
    local = shard_batch({"points": pts}, mesh)["points"]
    _reset_launches()
    poses, found = step(local)
    _sync(dev)
    out = {"launches": _launches()}
    with torch.inference_mode():
        from tpufusion_torch.geometry.range_view import range_view_project_batch

        heat = heat_mask(model(range_view_project_batch(local, spec))[..., 1], dcfg)
    out["kernels"] = _hold_kernels(local, spec, heat)
    poses, found = all_gather_rows(poses, mesh), all_gather_rows(found, mesh)
    if mesh.rank == 0:
        ref_poses, ref_found = step(torch.from_numpy(pts).to(dev))
        out["found_equal"] = bool(torch.equal(found, ref_found))
        out["found"] = int(found.sum())
        out["pose_abs"] = float((poses - ref_poses).abs().max())
    return out


def _rank_phases(mesh, spec: RangeViewSpec, frames: int, n_points: int, full_points: int,
                 timed_steps: int, outdir: str) -> None:
    from tpufusion_torch.data.synthetic import synthesize_points_batch
    from tpufusion_torch.models.fcn import FCN

    dev, n = mesh.device, mesh.world_size
    res = {"train": _train_phase(mesh, spec, frames, n_points, timed_steps)}
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
) -> dict:
    """Runs the four phases of the module docstring on `n_devices` ranks
    and asserts each against one process. `device` "cuda" gives each rank
    its card; "cuda:0" with backend="gloo" puts every rank on card 0;
    "cpu" runs gloo ranks on the CPU. Phases 1-3 run `spec` on
    `frames_per_rank` * n frames of `n_points` points, phase 4 the full geometry on n frames of
    `full_points`. `timed_steps` > 0 also times the sharded train step and
    its gradient all-reduce alone and, on rank 0, the one-process step on
    the global batch (host clock, the card synchronized).
    Returns {"mesh", "lines", "launches" (each kernel's launches summed
    over the ranks' sharded calls), "ranks" (each rank's readings)}."""
    device = torch.device(device)
    if device.type == "cuda":
        from tpufusion_torch import _build

        torch.empty(0, device=device)  # without a card, raise here
        _build.load()  # build the kernels once, before the ranks load them
    mesh_shape = {"data": n_devices}
    with tempfile.TemporaryDirectory() as outdir:
        spawn(_rank_phases, n_devices, device, backend,
              (spec, frames_per_rank, n_points, full_points, timed_steps, outdir), timeout)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(outdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    lead = ranks[0]
    train = lead["train"]
    assert np.isfinite(train["loss"]), f"non-finite loss {train['loss']}"
    assert train["loss_rel"] <= LOSS_RTOL, f"sharded loss off by {train['loss_rel']:.3e}"
    assert train["metrics_rel"] <= LOSS_RTOL, f"sharded metrics off by {train['metrics_rel']:.3e}"
    assert train["grad_rel"] <= GRAD_RTOL, f"sharded gradients off by {train['grad_rel']:.3e}"
    assert train["param_abs"] <= PARAM_ATOL, f"sharded parameters off by {train['param_abs']:.3e}"
    assert train["stats_rel"] <= STATS_RTOL, f"BatchNorm statistics off by {train['stats_rel']:.3e}"
    assert all(r["train"]["replica_max_diff"] == 0.0 for r in ranks), "the replicas drifted apart"
    lines = [
        f"dryrun_multichip train-step ok: {n_devices} devices (mesh {mesh_shape}), batch "
        f"{frames_per_rank * n_devices}, loss {train['loss']:.4f}; against one process: loss {train['loss_rel']:.2e} "
        f"relative, gradients {train['grad_rel']:.2e} of each tensor's largest entry (worst "
        f"{train['grad_worst'][-1]}; the one-process step twice {train['grad_rel_repeat']:.2e}), parameters "
        f"{train['param_abs']:.2e} where |g| > {ADAM_FLOOR:.0e} ({train['param_abs_all']:.2e} "
        f"anywhere), BatchNorm statistics {train['stats_rel']:.2e}, metrics {train['metrics_rel']:.2e} relative"]
    names = {"corner": "e2e-inference (projection+FCN+corner decode)",
             "flagship": "flagship (direct head, width 2)",
             "full_width": "full-width flagship (32x1801)"}
    for phase, what in names.items():
        got = lead[phase]
        assert got["found_equal"], f"{phase}: found differs from one process"
        assert got["pose_abs"] <= POSE_ATOL, f"{phase}: poses off by {got['pose_abs']:.3e}"
        lines.append(f"dryrun_multichip {phase} ok: {what} sharded over {mesh_shape}, poses match "
                     f"one process within {got['pose_abs']:.2e} (found {got['found']})")
    launches = dict.fromkeys(KERNELS, 0)
    for r in ranks:
        for phase in ("train", *names):
            for k, v in r[phase]["launches"].items():
                launches[k] += v
            bad = [k for k, v in r[phase]["kernels"].items() if k.endswith("equal") and not v]
            assert not bad, f"{phase}: {bad} differ from the plain versions"
    for line in lines:
        print(line, flush=True)
    return {"mesh": mesh_shape, "lines": lines, "launches": launches, "ranks": ranks}


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
