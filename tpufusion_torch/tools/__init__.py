"""Host tools of the port (counterparts of `tpufusion/tools/`).

The training and tuning tools write their assets under `ASSETS`
(`tpufusion_torch/assets/`, made on demand and left out of git). They
may read the JAX package's shipped assets but never write into that
package: `refuse_reference_path` raises before any work when an output
would land under `tpufusion/`.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS = os.path.join(_REPO, "tpufusion_torch", "assets")
_REFERENCE = os.path.join(_REPO, "tpufusion")


def refuse_reference_path(path: str, hint: str) -> None:
    """Raises ValueError when `path` lies under the JAX package's
    directory (`tpufusion/`), which the port never writes to. `hint` says
    what the caller can do instead."""
    real = os.path.realpath(path)
    if os.path.commonpath([real, os.path.realpath(_REFERENCE)]) == os.path.realpath(_REFERENCE):
        raise ValueError(f"{path} lies in the JAX package (tpufusion/), which the port never "
                         f"writes to: {hint}")
