"""Fixed-grid ODE integrators (port of ``vit4hep_tpu/ops/ode.py``).

The JAX module runs the grid as one ``lax.scan``; here it is a Python loop
over eager calls. ``method="rk4"`` is torchdiffeq's Kutta 3/8 rule, not the
classic tableau (that one is ``rk4_classic``). The grid keeps torchdiffeq's
truncated final step when the step size does not divide the interval.
"""

from __future__ import annotations

import numpy as np


def _euler_step(f, t, dt, y):
    return y + dt * f(t, y)


def _midpoint_step(f, t, dt, y):
    half = f(t + dt / 2, y + (dt / 2) * f(t, y))
    return y + dt * half


def _rk4_38_step(f, t, dt, y):
    # Kutta 3/8 rule (torchdiffeq rk4_alt_step_func)
    k1 = f(t, y)
    k2 = f(t + dt / 3, y + dt * k1 / 3)
    k3 = f(t + dt * 2 / 3, y + dt * (k2 - k1 / 3))
    k4 = f(t + dt, y + dt * (k1 - k2 + k3))
    return y + dt * (k1 + 3 * (k2 + k3) + k4) / 8


def _rk4_classic_step(f, t, dt, y):
    k1 = f(t, y)
    k2 = f(t + dt / 2, y + dt * k1 / 2)
    k3 = f(t + dt / 2, y + dt * k2 / 2)
    k4 = f(t + dt, y + dt * k3)
    return y + dt * (k1 + 2 * k2 + 2 * k3 + k4) / 6


_STEPPERS = {
    "euler": _euler_step,
    "midpoint": _midpoint_step,
    "rk4": _rk4_38_step,
    "rk4_classic": _rk4_classic_step,
}

NET_EVALS_PER_STEP = {"euler": 1, "midpoint": 2, "rk4": 4, "rk4_classic": 4}


def odeint(f, y0, t0=0.0, t1=1.0, method="rk4", step_size=0.05, unroll=None):
    """Integrate dy/dt = f(t, y) from t0 to t1 on a fixed grid; returns y(t1).

    ``f`` receives ``t`` as a float. The full-step times are float32, as the
    JAX scan computes them (``t0 + dt * arange(n, float32)``). ``unroll`` is
    accepted for config compatibility and ignored: an eager loop has nothing
    to unroll."""
    del unroll
    if method not in _STEPPERS:
        raise ValueError(f"ODE method '{method}' not implemented ({list(_STEPPERS)})")
    stepper = _STEPPERS[method]
    n_full, remainder = _grid_plan(step_size, t0, t1)
    if n_full <= 0 and remainder == 0.0:
        raise ValueError(f"step_size {step_size} too large for interval [{t0}, {t1}]")
    dt = step_size
    ts = np.float32(t0) + np.float32(dt) * np.arange(n_full, dtype=np.float32)
    y = y0
    for t in ts:
        y = stepper(f, float(t), dt, y)
    if remainder > 0.0:
        y = stepper(f, t0 + dt * n_full, remainder, y)
    return y


def _grid_plan(step_size: float, t0: float, t1: float) -> tuple[int, float]:
    """(n_full_steps, truncated_remainder) of the fixed grid: full steps of
    ``step_size`` plus one truncated final step when it does not divide the
    interval. Shared by :func:`odeint` and :func:`grid_steps`."""
    span = t1 - t0
    if step_size <= 0 or span <= 0:
        raise ValueError(f"step_size {step_size} too large for interval [{t0}, {t1}]")
    n_full = int(span / step_size + 1e-9)
    remainder = span - n_full * step_size
    if remainder < 1e-9 * max(1.0, abs(span)):
        remainder = 0.0
    return n_full, remainder


def grid_steps(step_size: float, t0: float = 0.0, t1: float = 1.0) -> int:
    """Number of stepper invocations odeint() makes for this grid."""
    n_full, remainder = _grid_plan(step_size, t0, t1)
    return n_full + (1 if remainder > 0.0 else 0)


def parse_odeint_kwargs(odeint_kwargs: dict | None) -> dict:
    """Translate the torchdiffeq kwargs layout (``{method: rk4, options:
    {step_size: 0.05}}``) into odeint() arguments."""
    odeint_kwargs = dict(odeint_kwargs or {})
    out = {"method": odeint_kwargs.get("method", "rk4")}
    options = odeint_kwargs.get("options") or {}
    if "step_size" in options:
        out["step_size"] = float(options["step_size"])
    if "unroll" in options:
        out["unroll"] = int(options["unroll"])
    return out
