"""Training: the step, the optimizer pieces, checkpoints and the trainers;
exports the names of `tpufusion/train/__init__.py`."""

from tpufusion_torch.train.stats import population_weights
from tpufusion_torch.train.train_step import make_eval_step, make_train_step
from tpufusion_torch.train.trainer import Trainer

__all__ = ["make_train_step", "make_eval_step", "Trainer", "population_weights"]
