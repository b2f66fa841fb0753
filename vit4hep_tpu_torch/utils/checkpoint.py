"""Checkpoints in the reference's run-dir layout (counterpart of
``vit4hep_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` dict at
``runs/<exp>/<run>/models/model_run{idx}.pt``, the reference's own file
layout: ``model`` (the state dict under the reference's parameter names),
``optimizer``, ``schedule`` (the LambdaLR state), ``ema`` (the shadow
parameters in ``model.parameters()`` order, or None), ``step``,
``ema_updates`` and ``lr_scale``. A tensor-parallel state saves its
split tensors whole (parameters, EMA, optimizer moments: gathered over the
model group, so every rank calls :func:`save_checkpoint` and only the one
asked to writes), and loads a whole checkpoint cut to its parts: a
checkpoint of any grid loads into any other.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from vit4hep_tpu_torch.parallel.sharding_rules import gather_state_dict, split_state_dict
from vit4hep_tpu_torch.utils.logger import LOGGER


def save_checkpoint(path, state, write=True):
    """Write ``state``'s whole state dict to ``path`` (a ``.pt`` file)
    when ``write``, through a temporary file so that a crash never leaves
    half a checkpoint."""
    sd = gather_state_dict(state)
    if not write:
        return
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save(sd, tmp)
    os.replace(tmp, path)
    LOGGER.debug(f"Saved checkpoint at {path}")


def load_checkpoint(path, state=None, map_location="cpu"):
    """The checkpoint dict at ``path``; loaded into ``state`` when given
    (each split tensor cut to this rank's part, in the returned dict too)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"Cannot load checkpoint from {path}")
    sd = torch.load(path, map_location=map_location, weights_only=True)
    if state is not None:
        state.load_state_dict(split_state_dict(state, sd))
    return sd
