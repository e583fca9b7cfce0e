"""Host -> device feeding: shuffled epoch batching (counterpart of
`tpufusion/data/pipeline.py`). Label encoding happens on the device inside
the train step, so the host only moves raw tensors.

`epoch_indices` reproduces the reference's epoch fill: when the dataset
does not divide by the batch size, the remainder is filled with extra
samples drawn from a second shuffle.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from tpufusion_torch.parallel.mesh import BatchSharding


def epoch_indices(
    n: int, batch_size: int, rng: np.random.Generator, shuffle: bool = True
) -> np.ndarray:
    """Indices covering one epoch, padded to a whole number of batches."""
    num_batches = n // batch_size + (1 if n % batch_size else 0)
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    need = num_batches * batch_size - n
    while need > 0:  # tiny datasets may need several refills
        extra = np.arange(n)
        if shuffle:
            rng.shuffle(extra)
        idx = np.concatenate([idx, extra[:need]])
        need -= min(need, n)
    return idx.reshape(num_batches, batch_size)


class BatchPipeline:
    """Iterates a dict-of-arrays dataset in batches of tensors on `device`
    (the card unless the caller asks for "cpu").

    Device-resident (the default whenever the data fits
    `device_budget_bytes`): the whole dataset is staged on the device once
    and each batch is gathered there, so a step costs no host copy at all.
    Otherwise each batch is cut on the host into pinned memory and copied
    with `non_blocking=True` one batch ahead of the consumer, so the copy
    of batch k+1 overlaps the work on batch k. Both give the same batches
    for the same seed.

    `sharding=batch_sharding(mesh)` (`parallel/mesh.py`): `batch_size` is
    the global batch; every rank draws the same `epoch_indices` from the
    same seed and yields its data row's rows [d B/n, (d+1) B/n) of each
    global batch (n data rows; the ranks of a row alike) on the mesh's
    device (`device` is then unused)."""

    def __init__(
        self,
        data: dict[str, np.ndarray],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        sharding=None,
        drop_remainder: bool = False,
        device_resident: bool | None = None,
        device_budget_bytes: int = 4 << 30,
        device: torch.device | str = "cuda",
    ):
        self.rows = slice(None)  # this rank's columns of the epoch plan
        if sharding is not None:
            if not isinstance(sharding, BatchSharding):
                raise TypeError("sharding must be parallel.mesh.batch_sharding(mesh), got "
                                f"{type(sharding).__name__}")
            self.rows = sharding.rows(batch_size)
            device = sharding.mesh.device
        self.data = {k: np.ascontiguousarray(v) for k, v in data.items()}
        self.n = len(next(iter(self.data.values())))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_remainder = drop_remainder
        self.device = torch.device(device)
        if device_resident is None:
            total = sum(v.nbytes for v in self.data.values())
            device_resident = total <= device_budget_bytes
        self._dev = None
        if device_resident:
            self._dev = {k: torch.from_numpy(v).to(self.device) for k, v in self.data.items()}
        elif self.device.type == "cuda":
            torch.empty(0, device=self.device)  # without a card, raise here, not mid-epoch

    @property
    def batches_per_epoch(self) -> int:
        if self.drop_remainder:
            return self.n // self.batch_size
        return self.n // self.batch_size + (1 if self.n % self.batch_size else 0)

    def _put(self, rows: np.ndarray) -> dict[str, torch.Tensor]:
        out = {}
        for k, v in self.data.items():
            host = torch.from_numpy(v[rows])
            if self.device.type == "cuda":
                host = host.pin_memory()
            out[k] = host.to(self.device, non_blocking=True)
        return out

    def epoch(self) -> Iterator[dict[str, torch.Tensor]]:
        plan = epoch_indices(self.n, self.batch_size, self.rng, self.shuffle)
        if self.drop_remainder:
            plan = plan[: self.n // self.batch_size]
        plan = np.ascontiguousarray(plan[:, self.rows])
        if self._dev is not None:
            # the whole epoch's row indices in one copy, from pinned memory:
            # a pageable copy a batch would make the host wait for the card
            plan_dev = torch.from_numpy(plan)
            if self.device.type == "cuda":
                plan_dev = plan_dev.pin_memory()
            plan_dev = plan_dev.to(self.device, non_blocking=True)
        pending = None
        for i, rows in enumerate(plan):
            if self._dev is not None:
                nxt = {k: v[plan_dev[i]] for k, v in self._dev.items()}
            else:
                nxt = self._put(rows)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def __iter__(self):
        while True:
            yield from self.epoch()
