"""Conditional invertible neural network (port of ``vit4hep_tpu/models/cinn.py``).

Maximum likelihood with ``log p(x|c) = -||z||^2/2 + log|det J| - d/2 log
2 pi``, ``z = f(x, c)`` the flow's forward pass; sampling draws ``z ~ N(0,
1)`` (or takes it from the caller) and runs the flow's inverse. The JAX
model wraps pure functions of ``(params, inputs, rng)``; here it is an
``nn.Module`` that owns its flow (``net.*`` in the state dict), and
randomness comes from an explicit ``torch.Generator``. ``log_prob`` and
``batch_loss`` are ported for parity on the CPU; training the cINN on the
card is not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class CINN(nn.Module):
    """Base cINN over x of shape ``(B, *shape)``; subclasses set ``self.net``
    (a ``FlowChain``) and the patching hooks."""

    model_type = "cinn"

    def __init__(self, shape, **_ignored):
        super().__init__()
        self.shape = tuple(int(s) for s in shape)
        self.in_channels = 1
        self.condition_dim = 1

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, *self.shape)

    def to_patches(self, x):
        return x

    def from_patches(self, x):
        return x

    def forward(self, x, c, rev=False):
        """rev=False: x -> (z, log|det J|); rev=True: z -> (x, log|det J^-1|)."""
        tokens = self.to_patches(x)
        z, log_jac = (self.net.inverse if rev else self.net)(tokens, c)
        return self.from_patches(z), log_jac

    def log_prob(self, x, c):
        """Mean conditional log-likelihood of the batch."""
        z, log_jac = self.forward(x, c)
        z = z.reshape(z.shape[0], -1)
        d = z.shape[1]
        lp = -0.5 * (z**2).sum(1) + log_jac - d / 2 * math.log(2 * math.pi)
        return lp.mean()

    def batch_loss(self, x, c, generator=None):
        return -self.log_prob(x, c)

    @torch.no_grad()
    def sample_batch(self, c, generator=None, z=None):
        """x for the condition ``c``: the flow's inverse at ``z`` (x shape),
        drawn from ``generator`` unless given."""
        shape = self.x_shape(c.shape[0])
        if z is None:
            z = torch.randn(shape, generator=generator, device=c.device, dtype=torch.float32)
        elif tuple(z.shape) != tuple(shape):
            raise ValueError(f"z has shape {tuple(z.shape)}, expected {tuple(shape)}")
        x, _ = self.forward(z, c, rev=True)
        return x.reshape(z.shape)

    def net_evals_per_sample(self) -> int:
        return 1

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
