"""Small utilities (counterpart of ``vit4hep_tpu/utils/misc.py``)."""

from __future__ import annotations

import contextlib
import functools
import logging
import math

import torch
import torch.nn.functional as F

_F32_NAMES = ("float32", "fp32", "float")
_BF16_NAMES = ("bfloat16", "bf16")


def get_dtype(name: str | None) -> torch.dtype:
    """A config dtype string as a torch dtype."""
    dtypes = {None: torch.float32, "float32": torch.float32, "float": torch.float32,
              "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
              "float64": torch.float64, "double": torch.float64,
              "float16": torch.float16, "half": torch.float16}
    if name not in dtypes:
        raise ValueError(f"dtype {name} not supported")
    return dtypes[name]


def compute_dtype(name: str | None) -> torch.dtype:
    """A net's ``compute_dtype`` as JAX's ``ViTParams.dtype`` and
    ``EnergyTransformerParams.dtype`` map it: bfloat16 for "bfloat16" and
    "bf16", float32 for anything else. A name that is neither an f32 nor a
    bf16 name logs a warning (one a net) and runs in float32, the numbers
    JAX gives it."""
    if name in _BF16_NAMES:
        return torch.bfloat16
    if name not in _F32_NAMES:
        logging.getLogger("vit4hep-tpu").warning(
            "compute_dtype %r is neither a float32 nor a bfloat16 name: the net computes in "
            "float32, as the JAX package's does", name)
    return torch.float32


def dense(x, weight, bias, dt):
    """A Dense layer computed in ``dt`` as flax's ``nn.Dense(dtype=dt)``
    does: the input and the (f32) parameters cast to ``dt``, the product
    rounded to ``dt``, then the bias added in ``dt``. In float32 it is one
    ``F.linear``; the gradients flow back to the f32 parameters."""
    if dt == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dt), weight.to(dt))
    return y if bias is None else y + bias.to(dt)


def silu(x):
    """SiLU as the JAX package computes it: ``F.silu`` in float32; in bf16
    ``x * logistic(x)`` with XLA's logistic ``1 / (1 + exp(-x))``, each op
    rounded to bf16 as each of XLA's ops is."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu_tanh(x):
    """The tanh GELU as ``jax.nn.gelu(approximate=True)``: ``F.gelu`` in
    float32; in bf16 its formula op by op, each op (x ** 3 as x * (x * x))
    and its two constants rounded to bf16."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c, k = (torch.tensor(v, dtype=x.dtype).item() for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


class SiLU(torch.nn.Module):
    """``torch.nn.SiLU`` as :func:`silu` computes it."""

    def forward(self, x):
        return silu(x)


class Dense(torch.nn.Linear):
    """``torch.nn.Linear`` computing in ``dt`` as flax's ``nn.Dense(dtype=
    dt)`` (:func:`dense`); :func:`set_compute_dtype` sets ``dt`` to the
    net's compute dtype. The parameter names are nn.Linear's."""

    dt = torch.float32

    def forward(self, x):
        return dense(x, self.weight, self.bias, self.dt)


def set_compute_dtype(net, dt):
    """Give every module of ``net`` that computes in a dtype (one with a
    ``dt``) the net's compute dtype."""
    for m in net.modules():
        if hasattr(m, "dt"):
            m.dt = dt


def layer_norm(x, dt, eps, weight=None, bias=None):
    """LayerNorm over the last axis computed as flax's ``nn.LayerNorm(dtype=
    dt)`` does: in float32 ``F.layer_norm``; in bf16 the mean and variance
    in f32 (the fast variance E[x^2] - E[x]^2, clipped at 0), the
    normalisation, scale and bias in f32, the result rounded to ``dt``. x
    is cast to f32 twice, for the statistics and for x - mean, as flax
    casts it in each place: its gradient is then the bf16 sum of the two
    casts' bf16 cotangents, as JAX's."""
    if dt == torch.float32:
        return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    xs = x.float()
    mu = xs.mean(-1, keepdim=True)
    var = torch.clamp((xs * xs).mean(-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (x.float() - mu) * mul
    if bias is not None:
        y = y + bias
    return y.to(dt)


def to_dtype(t, dtype):
    """``t`` in ``dtype``; ``t`` itself when it is (a traced program then
    records no conversion)."""
    return t if t.dtype == dtype else t.to(dtype)


def f32(t):
    """``t`` in float32; ``t`` itself when it is."""
    return to_dtype(t, torch.float32)


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
