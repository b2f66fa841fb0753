"""Small utilities (counterpart of ``vit4hep_tpu/utils/misc.py``)."""

from __future__ import annotations

import contextlib
import functools

import torch


def get_dtype(name: str | None) -> torch.dtype:
    """A config dtype string as a torch dtype."""
    dtypes = {None: torch.float32, "float32": torch.float32, "float": torch.float32,
              "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float64": torch.float64, "double": torch.float64,
              "float16": torch.float16, "half": torch.float16}
    if name not in dtypes:
        raise ValueError(f"dtype {name} not supported")
    return dtypes[name]


def f32(t):
    """``t`` in float32; ``t`` itself when it is (a traced program then
    records no conversion)."""
    return t if t.dtype == torch.float32 else t.float()


def no_grad():
    """``torch.no_grad()``, or nothing where gradients are off already: a
    program traced without gradients (``torch.export``) then records no
    grad-mode switch, which export would have to split the graph at."""
    return torch.no_grad() if torch.is_grad_enabled() else contextlib.nullcontext()


def without_grad(fn):
    """``fn`` called under :func:`no_grad` (a decorator)."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with no_grad():
            return fn(*args, **kwargs)

    return call


def flatten_dict(d, parent_key: str = "", sep: str = "."):
    """Flatten a nested mapping into dotted keys."""
    items = {}
    try:
        entries = d.items()
    except AttributeError:
        return {parent_key: d}
    for k, v in entries:
        new_key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if hasattr(v, "items"):
            items.update(flatten_dict(v, new_key, sep=sep))
        else:
            items[new_key] = v
    return items


def count_parameters(module: torch.nn.Module) -> int:
    """Number of trainable parameters."""
    return sum(p.numel() for p in module.parameters() if p.requires_grad)
