"""Conditional Flow Matching generative model (port of ``vit4hep_tpu/models/cfm.py``).

The JAX model is a thin wrapper over pure functions of ``(params, inputs,
rng)``; here it is an ``nn.Module`` that owns its net (``net.*`` in the state
dict, as the reference's), and randomness comes from an explicit
``torch.Generator`` or from noise handed in by the caller.
"""

from __future__ import annotations

import torch
from torch import nn

from vit4hep_tpu_torch.models.trajectories import get_trajectory
from vit4hep_tpu_torch.models.vit import sampling_variant
from vit4hep_tpu_torch.ops.ode import NET_EVALS_PER_STEP, grid_steps, odeint, parse_odeint_kwargs
from vit4hep_tpu_torch.utils.misc import without_grad


def draw(fn, shape, generator, like, rows=None):
    """``fn`` (``torch.rand`` / ``torch.randn``) of ``shape`` from
    ``generator`` on ``like``'s device and dtype; with ``rows``, of the
    global batch's shape, cut to ``rows``: each rank of a data-parallel
    step keeps its rows of the draws a one-rank step makes."""
    if rows is None:
        return fn(shape, generator=generator, device=like.device, dtype=like.dtype)
    out = fn((rows.total, *shape[1:]), generator=generator, device=like.device, dtype=like.dtype)
    return out[rows.start:rows.stop]


class CFM(nn.Module):
    """Base CFM over flat vectors (the energy model: shape=[n_layers])."""

    model_type = "cfm"

    def __init__(self, net, shape, time_distribution="uniform", trajectory="linear",
                 odeint_kwargs=None, **_ignored):
        super().__init__()
        if time_distribution != "uniform":
            raise ValueError(f"time_distribution '{time_distribution}' not implemented")
        self.net = net
        self.shape = tuple(int(s) for s in shape)
        self.trajectory = get_trajectory(trajectory)
        self.ode_kwargs = parse_odeint_kwargs(odeint_kwargs)

    @property
    def sample_net(self):
        """Forward-only twin for the sampling ODE: the same parameters, with
        the kernel path enabled when the config says ``fused_block: sample``."""
        return sampling_variant(self.net)

    @property
    def condition_dim(self) -> int:
        cfg = self.net.cfg
        return getattr(cfg, "condition_dim", None) or getattr(cfg, "dims_c")

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, *self.shape)

    def _net_args(self, x, t, c):
        """Hook for patching subclasses; the base model feeds the net directly."""
        return (x, t, c)

    def _net_out(self, z, x_shape):
        return z

    def forward(self, x, t, c):
        """Velocity field. x: (B, *shape); t: (B, 1); c: (B, K)."""
        return self._net_out(self.net(*self._net_args(x, t, c)), x.shape)

    def batch_loss(self, x, c, generator=None, t=None, x_0=None, rows=None):
        """Flow-matching loss of one batch: t ~ U(0, 1) per element (shape
        (B, 1, ...) broadcasting over x) and x_0 ~ N(0, 1) are drawn from
        ``generator`` unless given, as ``sample_batch`` takes ``x_T``.
        ``rows`` (``parallel/mesh.Rows``): x is these rows of a global batch,
        whose draws are made and these rows of them kept."""
        bcast = (x.shape[0],) + (1,) * (x.ndim - 1)
        if t is None:
            t = draw(torch.rand, bcast, generator, x, rows)
        if x_0 is None:
            x_0 = draw(torch.randn, x.shape, generator, x, rows)
        if tuple(t.shape) != bcast or x_0.shape != x.shape:
            raise ValueError(f"t {tuple(t.shape)} / x_0 {tuple(x_0.shape)} do not fit x "
                             f"{tuple(x.shape)}")
        x_t, x_t_dot = self.trajectory(x_0, x, t)
        velocity = self.forward(x_t, t.reshape(-1, 1), c)
        return torch.mean((velocity - x_t_dot) ** 2)

    def token_shape(self, batch_size: int):
        """Patching subclasses return (B, T, P) to integrate the sampling ODE
        in token space; None integrates in x-space."""
        return None

    @without_grad
    def sample_batch(self, c, generator=None, x_T=None):
        """Integrate the learned velocity field t: 0 -> 1 from x_T ~ N(0, 1).

        ``x_T`` is the initial noise when given (token shape for patching
        models, x shape otherwise); else it is drawn from ``generator``."""
        tshape = self.token_shape(c.shape[0])
        shape = self.x_shape(c.shape[0]) if tshape is None else tshape
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=c.device, dtype=torch.float32)
        elif tuple(x_T.shape) != tuple(shape):
            raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {tuple(shape)}")
        net = self.sample_net

        if tshape is None:
            # a net that encodes its condition (the energy transformer) does so
            # once: the condition is the same at every eval
            memory = net.condition_memory(c) if hasattr(net, "condition_memory") else None
            extra = {} if memory is None else {"memory": memory}

            def f(t, x_t):
                t_b = torch.full((x_t.shape[0], 1), t, dtype=x_t.dtype, device=x_t.device)
                return self._net_out(net(*self._net_args(x_t, t_b, c), **extra), x_t.shape)

            return odeint(f, x_T, t0=0.0, t1=1.0, **self.ode_kwargs)

        def f(t, tokens):
            t_b = torch.full((tokens.shape[0], 1), t, dtype=tokens.dtype, device=tokens.device)
            return net(tokens, t_b, c)

        return self.from_patches(odeint(f, x_T, t0=0.0, t1=1.0, **self.ode_kwargs))

    def net_evals_per_sample(self) -> int:
        method = self.ode_kwargs.get("method", "rk4")
        step = self.ode_kwargs.get("step_size", 0.05)
        return NET_EVALS_PER_STEP[method] * grid_steps(step)

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())
