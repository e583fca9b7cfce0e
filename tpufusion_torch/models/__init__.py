"""The FCN, the fusion net, the losses and metrics, npz weights in and
out; exports the names of `tpufusion/models/__init__.py`."""

from tpufusion_torch.models.fcn import FCN
from tpufusion_torch.models.losses import weighted_pose_loss
from tpufusion_torch.models.metrics import batch_metrics

__all__ = ["FCN", "weighted_pose_loss", "batch_metrics"]
