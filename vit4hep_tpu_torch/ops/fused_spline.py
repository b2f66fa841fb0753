"""Binned-RQS inverse and its log-determinant in one pass (port of
``vit4hep_tpu/ops/fused_spline.py``, kernel K4).

:func:`fused_binned_rqs_inverse` takes the JAX function's arguments: the
points ``y`` (B, D) in the spline's codomain and the raw subnet outputs
``theta`` (B, D, P). It returns ``(x, logdet)``: x (B, D) and the
inverse's log-determinant (B,), minus the sum over D of the forward
log-derivative. On CPU tensors it runs :func:`inverse_plain`, which is
``binned_rqs(y, binned_constrain(theta, ...), rev=True)`` of
``ops/rqs.py``. On CUDA tensors it launches ``csrc/binned_rqs.cu`` once, at
any batch, or raises: persistent CTAs take contiguous chunks of the B * D
scalars in units of :data:`UNIT` (a unit may span rows); in each, a
producer thread bulk-copies each unit's theta and y slices into a ring of
shared-memory stages while the consumer threads compute one
scalar each. The log-derivatives are summed per row in a fixed order:
within a chunk through a carry; a row that spans chunks through one
partial per CTA, tagged with the launch's epoch and counted per row in
``rows_done``, which the kernel leaves at zero. So the result is the same
from run to run. :func:`plan` is the work list and the stage layout the
kernel is given (``SplineArgs`` mirrors its C struct); :func:`chunk_start`,
:func:`cta_of`, :func:`ctas_of_row` and :func:`unit_segments` state how
the kernel splits it. The TPU kernel's ``group`` (batch
rows per grid step, a tiling knob of its (8, 128) layout) is accepted and
does not change the work here. The kernel is forward-only, as the TPU
kernel is: the cINN's likelihood direction runs the composed spline.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.rqs import binned_constrain, binned_rqs, n_params

MAX_BINS = 16  # the bin counts csrc/binned_rqs.cu instantiates: 1..MAX_BINS
UNIT = 128  # scalars a work unit, one per consumer thread (the kernel's T)
_Y_REGION = UNIT * 4 + 16  # a stage's y slice with room for a 16-byte lead
_SIGNATURES = {"binned_rqs_inverse": [_cuda.P, _cuda.I, _cuda.I, _cuda.P]}

INVERSE = _cuda.LaunchCounter("binned_rqs_inverse")


class SplineArgs(ctypes.Structure):
    """The kernel's ``SplineArgs`` (csrc/binned_rqs.cu), field by field."""
    _fields_ = ([(name, ctypes.c_void_p)
                 for name in ("y", "theta", "x", "logdet", "partial", "rows_done")]
                + [(name, ctypes.c_longlong) for name in ("n", "units")]
                + [(name, ctypes.c_int) for name in ("D", "P", "stage_bytes", "epoch")]
                + [(name, ctypes.c_float) for name in ("min_w", "min_h", "left0", "bottom0",
                                                        "default_width", "xshift", "yshift",
                                                        "clamp")])


class Plan(NamedTuple):
    n: int  # B * D scalars
    units: int  # ceil(n / UNIT)
    partials: int  # units + B >= grid + B: CTA c's partial of row r at index c + r
    stage_bytes: int  # theta's slice and y's, each with room for a 16-byte lead


def plan(b, d, p) -> Plan:
    """The kernel's work list and ring for y (b, d) and theta (b, d, p);
    the grid (as many CTAs as fit on the card, at most one a unit) is the
    kernel's own."""
    n = b * d
    units = -(-n // UNIT)
    return Plan(n, units, units + b, UNIT * p * 4 + 16 + _Y_REGION)


def chunk_start(c, units, grid):
    """The first unit of CTA c's contiguous chunk (the first units % grid
    CTAs take one unit more)."""
    base, extra = divmod(units, grid)
    return c * base + min(c, extra)


def cta_of(u, units, grid):
    """The CTA whose chunk holds unit u."""
    base, extra = divmod(units, grid)
    cut = extra * (base + 1)
    return u // (base + 1) if u < cut else extra + (u - cut) // base


def ctas_of_row(r, d, units, grid):
    """(first CTA, number of CTAs) whose chunks hold a scalar of row r; the
    row's partials are at first + r onwards."""
    first = cta_of(r * d // UNIT, units, grid)
    return first, cta_of((r * d + d - 1) // UNIT, units, grid) - first + 1


def unit_segments(u, n, d):
    """[(row, lo, hi)]: the rows unit ``u`` of an n-scalar work list
    touches, each with its scalars [lo, hi) within the unit, as the kernel
    cuts them (consumer j sums segment j)."""
    s0 = u * UNIT
    count = min(UNIT, n - s0)
    r0, c0 = divmod(s0, d)
    nseg = (c0 + count - 1) // d + 1
    return [(r0 + j, 0 if j == 0 else j * d - c0, min(count, (j + 1) * d - c0))
            for j in range(nseg)]


def bulk_copy(addr, count_bytes):
    """(source address, bytes, lead) of one slice's bulk copy: read from the
    16-byte boundary at or below ``addr``, rounded up to 16 bytes; the
    slice starts ``lead`` bytes into its stage region."""
    lead = addr & 15
    return addr - lead, (lead + count_bytes + 15) // 16 * 16, lead


class _Scratch:
    """The kernel's scratch on one (device, stream): the per-row counts,
    which it takes zeroed and leaves zeroed, and the tagged partials, each
    word written with the launch's epoch (0, the zeros' tag, is never one);
    grown when a larger call comes."""

    def __init__(self):
        self.rows_done = self.partial = None
        self.epoch = 0

    def take(self, b, partials, device):
        if self.rows_done is None or self.rows_done.numel() < b:
            self.rows_done = torch.zeros(b, dtype=torch.int32, device=device)
        if self.partial is None or self.partial.numel() < partials:
            self.partial = torch.zeros(partials, dtype=torch.int64, device=device)
        self.epoch = self.epoch % (2 ** 31 - 1) + 1
        return self.rows_done, self.partial, self.epoch


_SCRATCH: dict = {}


def _scratch(device) -> _Scratch:
    return _SCRATCH.setdefault((device, torch.cuda.current_stream(device).cuda_stream), _Scratch())


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
    if domain_clamping is not None and not domain_clamping > 0:
        raise ValueError(f"fused_binned_rqs_inverse: domain_clamping {domain_clamping} must be "
                         "positive or None")
    x = torch.empty_like(y)
    pl = plan(b, d, p)
    rows_done, partial, epoch = _scratch(y.device).take(b, pl.partials, y.device)
    logdet = torch.empty((b,), dtype=torch.float32, device=y.device)
    dom = [float(v) for v in default_domain]
    xshift = yshift = 0.0
    if not identity_tails:
        xshift = float(np.log(np.exp((dom[1] - dom[0]) / bins - min_bin_sizes[0]) - 1))
        yshift = float(np.log(np.exp((dom[3] - dom[2]) / bins - min_bin_sizes[1]) - 1))
    args = SplineArgs(y.data_ptr(), theta.data_ptr(), x.data_ptr(), logdet.data_ptr(),
                      partial.data_ptr(), rows_done.data_ptr(), pl.n, pl.units, d, p,
                      pl.stage_bytes, epoch, float(min_bin_sizes[0]),
                      float(min_bin_sizes[1]), dom[0], dom[2], dom[1] - dom[0], xshift, yshift,
                      0.0 if domain_clamping is None else float(domain_clamping))
    lib = _cuda.load("binned_rqs", _SIGNATURES)
    code = lib.binned_rqs_inverse(ctypes.addressof(args), bins, int(bool(identity_tails)),
                                  _cuda.stream())
    _cuda.check(code, "binned_rqs_inverse")
    INVERSE.add()
    return x, logdet
