"""Rider/bicycle dynamics models of the PyTorch port.

Each model module exposes ``N_STATES``, the default force names
``DEST_FORCE`` / ``REP_FORCE``, ``STATE_WIDTHS`` and
``step(params, state, fx, fy) -> state``.
"""

from cyclistsocialforce_tpu_torch.models import bicycle2d

MODELS = {
    "bicycle2d": bicycle2d,   # reference "planartwowheel" / Bicycle
}

__all__ = ["MODELS", "bicycle2d"]
