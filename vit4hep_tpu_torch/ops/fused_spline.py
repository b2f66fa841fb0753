"""Binned-RQS inverse and its log-determinant in one pass (port of
``vit4hep_tpu/ops/fused_spline.py``, kernel K4).

:func:`fused_binned_rqs_inverse` takes the JAX function's arguments: the
points ``y`` (B, D) in the spline's codomain and the raw subnet outputs
``theta`` (B, D, P). It returns ``(x, logdet)``: x (B, D) and the
inverse's log-determinant (B,), minus the sum over D of the forward
log-derivative. On CPU tensors it runs :func:`inverse_plain`, which is
``binned_rqs(y, binned_constrain(theta, ...), rev=True)`` of
``ops/rqs.py``. On CUDA tensors it launches ``csrc/binned_rqs.cu`` or
raises: one thread per scalar reads its P parameters once, keeps knots and
derivatives in registers and writes x; each CTA writes one partial
log-derivative sum per row, and a second small kernel adds the partials of
a row in a fixed order, so the result is the same from run to run. The
TPU kernel's ``group`` (batch rows per grid step, a tiling knob of its
(8, 128) layout) is accepted and does not change the work here. The
kernel is forward-only, as the TPU kernel is: the cINN's likelihood
direction runs the composed spline.
"""

from __future__ import annotations

import numpy as np
import torch

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.rqs import binned_constrain, binned_rqs, n_params

MAX_BINS = 16  # the bin counts csrc/binned_rqs.cu instantiates: 1..MAX_BINS
_THREADS = 128  # scalars per CTA
_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_SIGNATURES = {
    "binned_rqs_inverse": [_P] * 5 + [_I] * 5 + [_F] * 8 + [_P],
}

INVERSE = _cuda.LaunchCounter("binned_rqs_inverse")


def inverse_plain(y, theta, bins, min_bin_sizes=(0.01, 0.01),
                  default_domain=(-15.0, 15.0, -15.0, 15.0), identity_tails=False,
                  domain_clamping=None):
    """The composed spline inverse: the CPU path and the kernel's oracle."""
    params = binned_constrain(theta, bins, tuple(min_bin_sizes), tuple(default_domain),
                              identity_tails, domain_clamping)
    return binned_rqs(y, params, rev=True)


def fused_binned_rqs_inverse(y, theta, bins, min_bin_sizes=(0.01, 0.01),
                             default_domain=(-15.0, 15.0, -15.0, 15.0), identity_tails=False,
                             domain_clamping=None, group=16):
    """(x (B, D), logdet (B,)) of the binned-RQS inverse at ``y`` (B, D)
    with raw parameters ``theta`` (B, D, P), P = ``rqs.n_params(bins,
    identity_tails)``."""
    del group  # the TPU kernel's batch tiling; no counterpart here
    args = (y, theta, bins, min_bin_sizes, default_domain, identity_tails, domain_clamping)
    if y.device.type == "cpu":
        return inverse_plain(*args)
    return binned_rqs_inverse_kernel(*args)


def binned_rqs_inverse_kernel(y, theta, bins, min_bin_sizes, default_domain, identity_tails,
                              domain_clamping):
    """Launch ``csrc/binned_rqs.cu`` on the current stream."""
    y, theta = y.contiguous(), theta.contiguous()
    _cuda.require_cuda("fused_binned_rqs_inverse", y, theta)
    if y.ndim != 2:
        raise ValueError(f"fused_binned_rqs_inverse: y has shape {tuple(y.shape)}, expected (B, D)")
    b, d = y.shape
    p = n_params(bins, identity_tails)
    if tuple(theta.shape) != (b, d, p):
        raise ValueError(f"fused_binned_rqs_inverse: theta has shape {tuple(theta.shape)}, "
                         f"expected {(b, d, p)} ({bins} bins, identity_tails={identity_tails})")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"fused_binned_rqs_inverse: {bins} bins, the kernel takes 1 to {MAX_BINS}")
    if b > 65535:
        raise ValueError(f"fused_binned_rqs_inverse: batch {b} above the grid's 65535")
    if domain_clamping is not None and not domain_clamping > 0:
        raise ValueError(f"fused_binned_rqs_inverse: domain_clamping {domain_clamping} must be "
                         "positive or None")
    chunks = -(-d // _THREADS)
    x = torch.empty_like(y)
    partial = torch.empty((b, chunks), dtype=torch.float32, device=y.device)
    logdet = torch.empty((b,), dtype=torch.float32, device=y.device)
    dom = [float(v) for v in default_domain]
    xshift = yshift = 0.0
    if not identity_tails:
        xshift = float(np.log(np.exp((dom[1] - dom[0]) / bins - min_bin_sizes[0]) - 1))
        yshift = float(np.log(np.exp((dom[3] - dom[2]) / bins - min_bin_sizes[1]) - 1))
    lib = _cuda.load("binned_rqs", _SIGNATURES)
    code = lib.binned_rqs_inverse(
        y.data_ptr(), theta.data_ptr(), x.data_ptr(), partial.data_ptr(), logdet.data_ptr(),
        b, d, bins, int(bool(identity_tails)), _THREADS,
        float(min_bin_sizes[0]), float(min_bin_sizes[1]), dom[0], dom[2], dom[1] - dom[0],
        xshift, yshift, 0.0 if domain_clamping is None else float(domain_clamping),
        _cuda.stream())
    _cuda.check(code, "binned_rqs_inverse")
    INVERSE.add()
    return x, logdet
