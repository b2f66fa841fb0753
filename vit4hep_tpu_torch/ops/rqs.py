"""Rational-quadratic spline on a predicted domain with affine tails (port
of the binned part of ``vit4hep_tpu/ops/rqs.py``; Durkan et al.,
arXiv:1906.04032, in the FrEIA "binned" parametrization of the
``CaloRQSplineFrEIA`` coupling block).

:func:`binned_constrain` turns the raw subnet outputs into knots,
derivatives and the affine tails; :func:`binned_rqs` applies the spline in
either direction. The knots are partial sums (:func:`_csum0`: a scan on
the CPU, a product with a triangular matrix on the card); the active bin's
parameters come from ``torch.gather``, where JAX takes a one-hot sum for
the TPU's sake: the same function. The inverse keeps the JAX solve
exactly: the Citardauq root ``2c / (-b - sqrt(disc))`` with its ``1e-30``
guard, xi clipped to [0, 1], and two Newton steps whose slope is floored
at ``1e-12``, all in float32.

:func:`nflows_rqs` is the nflows parametrization of the energy cINN and the
``CaloRQSplineNFlows`` blocks: a fixed domain [-B, B], softmax widths and
heights floored at ``MIN_BIN_WIDTH`` / ``MIN_BIN_HEIGHT``, softplus knot
derivatives floored at ``MIN_DERIVATIVE``, and identity outside the domain.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

MIN_BIN_WIDTH = 1e-6
MIN_BIN_HEIGHT = 1e-6
MIN_DERIVATIVE = 1e-6


def _softplus(x):
    """log(1 + exp(x)) in the form of ``jax.nn.softplus`` (``logaddexp(x, 0)``)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _searchsorted(knots, x):
    """Index of the bin containing x: the largest i with knots[..., i] <= x,
    clipped to the bins."""
    return torch.clamp((x[..., None] >= knots).sum(-1) - 1, 0, knots.shape[-1] - 2)


@functools.lru_cache(maxsize=None)
def _triangle(k, dtype, device):
    """The (k, k + 1) strictly upper-triangular matrix of ones."""
    return torch.ones(k, k + 1, dtype=dtype, device=device).triu(1)


def _csum0(vals):
    """``[0, cumsum(vals)]`` along the last axis. On the card, one product
    with a strictly upper-triangular matrix of ones, as JAX forms it:
    torch's scan over a last axis of a few bins runs far below the memory
    rate there (1.2 ms a call at the ds2 cINN's (64, 3240, 10) on an H100,
    38% of a train step's device time). Its products are exact (x 1 or x
    0), so only the order of the f32 additions differs from the scan the
    CPU keeps."""
    if vals.is_cuda:
        return vals @ _triangle(vals.shape[-1], vals.dtype, vals.device)
    return torch.cat([torch.zeros_like(vals[..., :1]), torch.cumsum(vals, -1)], dim=-1)


def _gather_bin_params(idx, knot_x, knot_y, derivs):
    """(xk, xkp, yk, ykp, dk, dkp): each knot array at ``idx`` and ``idx + 1``."""
    lo, hi = idx[..., None], idx[..., None] + 1
    out = []
    for arr in (knot_x, knot_y, derivs):
        out += [torch.gather(arr, -1, lo)[..., 0], torch.gather(arr, -1, hi)[..., 0]]
    return out


def _rq_bin(x_or_y, xk, xkp, yk, ykp, dk, dkp, rev):
    """One rational-quadratic bin, elementwise: the forward map (eq. 4) or
    its inverse (eq. 6-8), and the log of the forward derivative (eq. 5) at
    the input (forward) or at the recovered point (inverse)."""
    dx = xkp - xk
    dy = ykp - yk
    sk = dy / dx

    def fwd_eval(xi):
        omx = 1 - xi
        num = dy * (sk * xi**2 + dk * xi * omx)
        den = sk + (dkp + dk - 2 * sk) * xi * omx
        return yk + num / den, den

    if not rev:
        xi = (x_or_y - xk) / dx
        out, _ = fwd_eval(xi)
        omx = 1 - xi
    else:
        # the Citardauq form of the quadratic root stays stable as a -> 0
        # (near-linear bins); two Newton steps polish it to f32 precision
        y_target = x_or_y
        t = y_target - yk
        qa = dy * (sk - dk) + t * (dkp + dk - 2 * sk)
        qb = dy * dk - t * (dkp + dk - 2 * sk)
        qc = -sk * t
        disc = torch.clamp_min(qb * qb - 4 * qa * qc, 0.0)
        denom = -qb - torch.sqrt(disc)
        denom = torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        xi = torch.clamp(2 * qc / denom, 0.0, 1.0)
        for _ in range(2):
            y_hat, den = fwd_eval(xi)
            omx = 1 - xi
            dy_dxi = sk**2 * (dkp * xi**2 + 2 * sk * xi * omx + dk * omx**2) / den**2 * dx
            xi = torch.clamp(xi - (y_hat - y_target) / torch.clamp_min(dy_dxi, 1e-12), 0.0, 1.0)
        out = xi * dx + xk
        omx = 1 - xi
    deriv_num = sk**2 * (dkp * xi**2 + 2 * sk * xi * omx + dk * omx**2)
    deriv_den = (sk + (dkp + dk - 2 * sk) * xi * omx) ** 2
    return out, torch.log(deriv_num) - torch.log(deriv_den)


def n_params(bins, identity_tails=False) -> int:
    """Raw spline parameters per transformed scalar."""
    return 2 * bins + (bins - 1) + (1 if identity_tails else 2)


def binned_constrain(theta, bins, min_bin_sizes=(0.01, 0.01),
                     default_domain=(-15.0, 15.0, -15.0, 15.0), identity_tails=False,
                     domain_clamping=None):
    """Split and constrain the raw spline parameters.

    theta: (..., D, P) with P = :func:`n_params`. Returns a dict of knot_x,
    knot_y, derivs (..., D, bins + 1) and the tails' scale, shift (..., D)."""
    widths_u = theta[..., :bins]
    heights_u = theta[..., bins:2 * bins]
    if identity_tails:
        total_width_u = theta[..., 2 * bins:2 * bins + 1]
        deltas_u = theta[..., 2 * bins + 1:]
    else:
        bottom_u = theta[..., 2 * bins:2 * bins + 1]
        left_u = theta[..., 2 * bins + 1:2 * bins + 2]
        deltas_u = theta[..., 2 * bins + 2:]

    def clamp_domain(d):
        if domain_clamping is None:
            return d
        return domain_clamping * torch.tanh(d / domain_clamping)

    if identity_tails:
        default_width = default_domain[1] - default_domain[0]
        total_width = default_width * _softplus(total_width_u + float(np.log(np.e - 1)))
        total_width = clamp_domain(total_width)
        left = -total_width / 2
        bottom = -total_width / 2
        widths = total_width * torch.softmax(widths_u, -1)
        heights = total_width * torch.softmax(heights_u, -1)
    else:
        left = left_u + default_domain[0]
        bottom = bottom_u + default_domain[2]
        default_bw = (default_domain[1] - default_domain[0]) / bins
        default_bh = (default_domain[3] - default_domain[2]) / bins
        xshift = float(np.log(np.exp(default_bw - min_bin_sizes[0]) - 1))
        yshift = float(np.log(np.exp(default_bh - min_bin_sizes[1]) - 1))
        widths = min_bin_sizes[0] + _softplus(widths_u + xshift)
        heights = min_bin_sizes[1] + _softplus(heights_u + yshift)
        domain_w = widths.sum(-1, keepdim=True)
        domain_h = heights.sum(-1, keepdim=True)
        w_resize = clamp_domain(domain_w) / domain_w
        h_resize = clamp_domain(domain_h) / domain_h
        widths = widths * w_resize
        heights = heights * h_resize
        left = left * w_resize
        bottom = bottom * h_resize

    knot_x = left + _csum0(widths)
    knot_y = bottom + _csum0(heights)
    # the boundary derivatives equal the tails' slope: C^1 across the edge
    scale = heights.sum(-1) / widths.sum(-1)
    deltas_inner = _softplus(deltas_u + float(np.log(np.e - 1)))
    derivs = torch.cat([scale[..., None], deltas_inner, scale[..., None]], dim=-1)
    shift = bottom[..., 0] - scale * left[..., 0]
    return {"knot_x": knot_x, "knot_y": knot_y, "derivs": derivs, "scale": scale,
            "shift": shift}


def binned_rqs(x, params, rev=False):
    """The spline on (..., D) inputs with :func:`binned_constrain`'s params.
    Returns (y, logdet) with logdet summed over D, negated when ``rev``."""
    knot_x, knot_y = params["knot_x"], params["knot_y"]
    derivs, scale, shift = params["derivs"], params["scale"], params["shift"]
    ref = knot_y if rev else knot_x
    inside = (x > ref[..., 0]) & (x <= ref[..., -1])
    tail = (x - shift) / scale if rev else scale * x + shift
    x_safe = torch.minimum(torch.maximum(x, ref[..., 0]), ref[..., -1])
    idx = _searchsorted(ref, x_safe)
    xk, xkp, yk, ykp, dk, dkp = _gather_bin_params(idx, knot_x, knot_y, derivs)
    y_spline, log_deriv = _rq_bin(x_safe, xk, xkp, yk, ykp, dk, dkp, rev)
    y = torch.where(inside, y_spline, tail)
    logdet = torch.where(inside, log_deriv, torch.log(scale)).sum(-1)
    return y, (-logdet if rev else logdet)


def nflows_knots(theta, num_bins, bound):
    """Split and constrain nflows spline parameters theta (..., 3 bins - 1):
    (knot_x, knot_y, derivs), each (..., bins + 1); the boundary
    derivatives are 1 (the identity tails' slope)."""
    uw = theta[..., :num_bins]
    uh = theta[..., num_bins:2 * num_bins]
    ud = theta[..., 2 * num_bins:]
    widths = MIN_BIN_WIDTH + (1 - MIN_BIN_WIDTH * num_bins) * torch.softmax(uw, -1)
    knot_x = 2 * bound * _csum0(widths) - bound
    heights = MIN_BIN_HEIGHT + (1 - MIN_BIN_HEIGHT * num_bins) * torch.softmax(uh, -1)
    knot_y = 2 * bound * _csum0(heights) - bound
    edge = torch.full_like(ud[..., :1], float(np.log(np.exp(1 - MIN_DERIVATIVE) - 1)))
    derivs = MIN_DERIVATIVE + _softplus(torch.cat([edge, ud, edge], dim=-1))
    return knot_x, knot_y, derivs


def nflows_rqs(x, theta, num_bins, bound, rev=False, event_mask=True):
    """The nflows spline on (..., D) inputs with raw parameters theta (..., D,
    3 bins - 1). Returns (y, logdet), logdet summed over D, negated when
    ``rev``: the log-derivative is always the forward one, at the recovered
    point in reverse.

    ``event_mask`` gates by event, as the reference does: an event is
    splined only if all of its D values lie in [-bound, bound]; otherwise
    it passes through unchanged with logdet 0, and its spline parameters
    get no gradient. Without it each value is gated on its own."""
    knot_x, knot_y, derivs = nflows_knots(theta, num_bins, bound)
    inside = (x >= -bound) & (x <= bound)
    x_safe = torch.clamp(x, -bound, bound)
    idx = _searchsorted(knot_y if rev else knot_x, x_safe)
    xk, xkp, yk, ykp, dk, dkp = _gather_bin_params(idx, knot_x, knot_y, derivs)
    y_spline, log_deriv = _rq_bin(x_safe, xk, xkp, yk, ykp, dk, dkp, rev)
    if event_mask:
        ev_inside = inside.all(-1, keepdim=True)
        y = torch.where(ev_inside, y_spline, x)
        logdet = torch.where(ev_inside[..., 0], log_deriv.sum(-1), torch.zeros_like(x[..., 0]))
    else:
        y = torch.where(inside, y_spline, x)
        logdet = torch.where(inside, log_deriv, torch.zeros_like(log_deriv)).sum(-1)
    return y, (-logdet if rev else logdet)
