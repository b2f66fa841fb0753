"""CFM interpolants (port of ``vit4hep_tpu/models/trajectories.py``)."""

from __future__ import annotations

import math

import torch


def linear_trajectory(x_0, x_1, t):
    x_t = (1 - t) * x_0 + t * x_1
    x_t_dot = x_1 - x_0
    return x_t, x_t_dot


def sine_cosine_trajectory(x_0, x_1, t):
    c = torch.cos(t * math.pi / 2)
    s = torch.sin(t * math.pi / 2)
    x_t = c * x_0 + s * x_1
    c_dot = -math.pi / 2 * s
    s_dot = math.pi / 2 * c
    x_t_dot = c_dot * x_0 + s_dot * x_1
    return x_t, x_t_dot


def sine2_cosine2_trajectory(x_0, x_1, t):
    c = torch.cos(t * math.pi / 2)
    s = torch.sin(t * math.pi / 2)
    x_t = c**2 * x_0 + s**2 * x_1
    c_dot = -math.pi / 2 * s
    s_dot = math.pi / 2 * c
    x_t_dot = 2 * c_dot * c * x_0 + 2 * s_dot * s * x_1
    return x_t, x_t_dot


def vp_trajectory(x_0, x_1, t, a=19.9, b=0.1):
    # e_dot reproduces the reference formula verbatim, which differs from
    # the analytic derivative 0.5*a*(1-t) + 0.5*b; kept for parity with the
    # JAX package (no shipped config reaches this interpolant).
    e = -0.25 * a * (1 - t) ** 2 - 0.5 * b * (1 - t)
    alpha_t = torch.exp(e)
    beta_t = torch.sqrt(1 - alpha_t**2)
    x_t = x_0 * alpha_t + x_1 * beta_t
    e_dot = 2 * a * (1 - t) + 0.5 * b
    alpha_t_dot = e_dot * alpha_t
    beta_t_dot = -2 * alpha_t * alpha_t_dot / beta_t
    x_t_dot = x_0 * alpha_t_dot + x_1 * beta_t_dot
    return x_t, x_t_dot


TRAJECTORIES = {
    "linear": linear_trajectory,
    "sine_cosine": sine_cosine_trajectory,
    "sine2_cosine2": sine2_cosine2_trajectory,
    "vp": vp_trajectory,
}


def get_trajectory(name: str):
    if name not in TRAJECTORIES:
        raise ValueError(f"trajectory '{name}' not in {list(TRAJECTORIES)}")
    return TRAJECTORIES[name]
