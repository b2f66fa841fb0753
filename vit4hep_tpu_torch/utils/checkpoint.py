"""Checkpoints in the reference's run-dir layout (counterpart of
``vit4hep_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` dict at
``runs/<exp>/<run>/models/model_run{idx}.pt``, the reference's own file
layout: ``model`` (the state dict under the reference's parameter names),
``optimizer``, ``schedule`` (the LambdaLR state), ``ema`` (the shadow
parameters in ``model.parameters()`` order, or None), ``step``,
``ema_updates`` and ``lr_scale``.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from vit4hep_tpu_torch.utils.logger import LOGGER


def save_checkpoint(path, state):
    """Write ``state.state_dict()`` to ``path`` (a ``.pt`` file), through a
    temporary file so that a crash never leaves half a checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    LOGGER.debug(f"Saved checkpoint at {path}")


def load_checkpoint(path, state=None, map_location="cpu"):
    """The checkpoint dict at ``path``; loaded into ``state`` when given."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Cannot load checkpoint from {path}")
    sd = torch.load(path, map_location=map_location, weights_only=True)
    if state is not None:
        state.load_state_dict(sd)
    return sd
