"""Training orchestration: epochs, validation, checkpoints, PR history
(counterpart of `tpufusion/train/trainer.py`).

A plain loop over the device-feeding pipeline, a `CheckpointManager`, an
in-memory metric history that serializes to the PR-curve CSV schema, a
per-epoch `metrics.jsonl`, divergence recovery from the last checkpoint
and an interrupt-safe final checkpoint.

The step loop makes no device -> host transfer: each step's metrics stay
0-d tensors on the device, queue up, and are read in one transfer every
`divergence_check_every` steps, so the host runs ahead of the card.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time

import numpy as np
import torch

from tpufusion_torch.config import PipelineConfig
from tpufusion_torch.data.pipeline import BatchPipeline
from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.train.checkpoint import CheckpointManager
from tpufusion_torch.train.optim import Adam, cosine_decay_schedule
from tpufusion_torch.train.train_step import make_eval_step, make_train_step

log = logging.getLogger("tpufusion_torch.trainer")

_PR_KEYS = ("loss", "precision", "recall")


class MetricHistory:
    """Per-batch and per-epoch precision / recall / loss."""

    def __init__(self):
        self.batch = {k: [] for k in _PR_KEYS}
        self.epoch = {k: [] for k in _PR_KEYS + tuple(f"val_{k}" for k in _PR_KEYS)}

    def record_batch(self, metrics):
        for k in _PR_KEYS:
            self.batch[k].append(float(metrics[k]))

    def record_epoch(self, train_metrics, val_metrics=None):
        for k in _PR_KEYS:
            self.epoch[k].append(float(train_metrics[k]))
            self.epoch[f"val_{k}"].append(
                float(val_metrics[k]) if val_metrics else float("nan")
            )

    def write_pr_csv(self, path: str):
        """epoch, loss, precision, recall (+ val): the PR plotter's schema."""
        cols = list(self.epoch)
        with open(path, "w", newline="") as f:
            wr = csv.writer(f)
            wr.writerow(["epoch"] + cols)
            for i in range(len(self.epoch["loss"])):
                wr.writerow([i] + [self.epoch[k][i] for k in cols])


def _to_host(pending: list[dict]) -> list[dict[str, float]]:
    """A span of queued device-side metrics in one device -> host transfer."""
    keys = list(pending[0])
    table = torch.stack([torch.stack([m[k] for k in keys]) for m in pending]).cpu().numpy()
    return [dict(zip(keys, row.tolist())) for row in table]


class Trainer:
    def __init__(
        self,
        cfg: PipelineConfig,
        model: FCN | None = None,
        outdir: str = "./runs/default",
        in_channels: int = 3,
        device: torch.device | str = "cuda",
    ):
        """The model (built from cfg.model with the reference's initializer
        and cfg.train.seed when none is given) is moved to `device`: the
        card unless the caller asks for "cpu". One `torch.Generator` on
        that device, seeded with cfg.train.seed, feeds the augmentation
        for the trainer's whole life and is saved with every checkpoint,
        so a resumed trainer draws what the interrupted one would have."""
        if cfg.model.head not in ("corner", "direct"):
            raise ValueError(f"unknown model head {cfg.model.head!r}")
        self.cfg = cfg
        self.outdir = outdir
        self.device = torch.device(device)
        os.makedirs(outdir, exist_ok=True)
        tcfg = cfg.train
        self.model = model if model is not None else FCN(cfg.model, in_channels, seed=tcfg.seed)
        self.model.to(self.device)
        self.optimizer = Adam(
            self.model.parameters(), tcfg.learning_rate, every_k=tcfg.grad_accum_steps)
        if tcfg.lr_schedule == "cosine":
            cosine_decay_schedule(
                self.optimizer, tcfg.lr_decay_steps or tcfg.epochs * 100, tcfg.lr_final_fraction)
        elif tcfg.lr_schedule != "constant":
            raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
        # the direct head's yaw codec has one source of truth a pipeline:
        # the decode must invert the codec the model was trained with
        yaw_frame = cfg.decode.direct_yaw_frame
        self.train_step = make_train_step(
            cfg.range_view, cfg.loss, tcfg, cfg.model.use_regression,
            head=cfg.model.head, yaw_frame=yaw_frame, device=self.device,
        )
        self.eval_step = make_eval_step(
            cfg.range_view, cfg.loss, cfg.model.use_regression,
            head=cfg.model.head, yaw_frame=yaw_frame, device=self.device,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.history = MetricHistory()
        self.ckpt = CheckpointManager(os.path.join(outdir, "ckpt"), keep=tcfg.keep_checkpoints)
        self.step = 0

    def _save(self) -> None:
        self.ckpt.save(self.step, self.model, self.optimizer, self.generator)

    def _restore(self) -> int:
        return self.ckpt.restore(
            self.model, self.optimizer, generator=self.generator, device=self.device)

    def resume(self) -> bool:
        try:
            self.step = self._restore()
        except FileNotFoundError:
            return False
        log.info("resumed from step %d", self.step)
        return True

    def _recover_from_divergence(self) -> bool:
        """On a non-finite loss, restore the last good checkpoint instead
        of training onward on poisoned weights."""
        try:
            self.step = self._restore()
        except FileNotFoundError:
            log.error("non-finite loss before any checkpoint exists: aborting "
                      "so poisoned weights are never persisted")
            return False
        log.warning("non-finite loss: restored checkpoint at step %d", self.step)
        return True

    def _append_metrics_jsonl(self, epoch, train_avg, val_avg=None) -> None:
        """Structured per-epoch scalars, consumable by any dashboard."""
        row = {"epoch": epoch, "step": self.step, "time": time.time()}
        row.update({k: float(v) for k, v in train_avg.items()})
        if val_avg:
            row.update({f"val_{k}": float(v) for k, v in val_avg.items()})
        with open(os.path.join(self.outdir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")

    def _params_finite(self) -> bool:
        with torch.no_grad():
            finite = torch.stack([torch.isfinite(p).all() for p in self.model.parameters()])
            return bool(finite.all())

    def _drain(self, pending: list, sums: dict, nb: int):
        """One host transfer for a span of queued device-side metrics.
        Returns (all_finite, nb, sums); on a non-finite loss the whole
        span is discarded (the weights are suspect from the divergence
        on, and the caller restores a checkpoint)."""
        host = _to_host(pending)
        if not all(np.isfinite(m["loss"]) for m in host):
            return False, nb, sums
        for m in host:
            self.history.record_batch(m)
            nb += 1
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + v
        return True, nb, sums

    def fit(
        self,
        train_pipe: BatchPipeline,
        val_pipe: BatchPipeline | None = None,
        epochs: int | None = None,
    ) -> MetricHistory:
        cfg = self.cfg.train
        epochs = epochs if epochs is not None else cfg.epochs
        check_every = max(int(cfg.divergence_check_every), 1)
        try:
            for epoch in range(epochs):
                t0 = time.time()
                sums, nb = {}, 0
                pending: list = []
                diverged_unrecoverable = False
                # no device -> host transfer in this loop: the metrics
                # queue on the device and drain every check_every steps
                for batch in train_pipe.epoch():
                    _, metrics = self.train_step(
                        self.model, self.optimizer, batch, self.generator)
                    pending.append(metrics)
                    self.step += 1
                    if len(pending) >= check_every:
                        ok, nb, sums = self._drain(pending, sums, nb)
                        pending = []
                        if not ok and not self._recover_from_divergence():
                            diverged_unrecoverable = True
                            break
                if pending and not diverged_unrecoverable:
                    ok, nb, sums = self._drain(pending, sums, nb)
                    if not ok and not self._recover_from_divergence():
                        diverged_unrecoverable = True
                if diverged_unrecoverable or nb == 0:
                    log.error("epoch %d: training diverged with nothing to "
                              "restore: aborting", epoch)
                    break
                train_avg = {k: v / nb for k, v in sums.items()}

                val_avg = None
                if val_pipe is not None:
                    queued = [self.eval_step(self.model, b)[1] for b in val_pipe.epoch()]
                    host = _to_host(queued) if queued else []
                    val_avg = {k: sum(m[k] for m in host) / max(len(host), 1)
                               for k in (host[0] if host else ())}

                self.history.record_epoch(train_avg, val_avg)
                self._append_metrics_jsonl(epoch, train_avg, val_avg)
                log.info(
                    "epoch %d: loss=%.4f prec=%.3f rec=%.3f%s (%.1fs)",
                    epoch, train_avg["loss"], train_avg["precision"], train_avg["recall"],
                    f" val_loss={val_avg['loss']:.4f}" if val_avg else "", time.time() - t0,
                )
                if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                    self._save()
        except KeyboardInterrupt:
            log.info("interrupted: saving final checkpoint")
        finally:
            # never persist non-finite weights as the latest checkpoint: a
            # later resume or recovery would restore them as if good
            if self._params_finite():
                self._save()
            else:
                log.error("final weights are non-finite: NOT checkpointing")
            self.history.write_pr_csv(os.path.join(self.outdir, "pr_curve.csv"))
        return self.history
