"""Checkpoints of model + optimizer + step (counterpart of
`tpufusion/train/checkpoint.py`, which keeps them with orbax).

One file a step, `ckpt_<step>.pt`: `torch.save` of the model's state dict,
the optimizer's (moments, counts, accumulated gradients, scheduler and
plateau state: `train.optim.Adam.state_dict`), the step and, when given, a
`torch.Generator`'s state. A file is written under a temporary name and
renamed, so a reader never sees half of one; the oldest beyond `keep` are
deleted; loading uses `weights_only=True`. A restore is exact, the
optimizer's moments included.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        found = (_NAME.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, model: torch.nn.Module, optimizer=None,
             generator: torch.Generator | None = None) -> None:
        payload = {"step": int(step), "model": model.state_dict()}
        if optimizer is not None:
            payload["opt"] = optimizer.state_dict()
        if generator is not None:
            payload["generator"] = generator.get_state()
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[: -self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, model: torch.nn.Module, optimizer=None, step: int | None = None,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cuda") -> int:
        """Loads the checkpoint of `step` (the latest without one) into
        `model` and, when given, `optimizer` and `generator`, in place,
        and returns its step. The model is moved to `device` (the card
        unless the caller asks for "cpu"). A checkpoint that holds an
        optimizer restores into a model alone; an empty directory raises
        FileNotFoundError."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        model.to(device)
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        model.load_state_dict(payload["model"])
        if optimizer is not None:
            optimizer.load_state_dict(payload["opt"])
        if generator is not None and "generator" in payload:
            generator.set_state(payload["generator"].cpu())
        return payload["step"]

    def close(self) -> None:
        """Nothing is held open; kept for the reference's interface."""
