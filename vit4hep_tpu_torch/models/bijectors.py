"""Invertible blocks of the conditional normalizing flow (port of the
``CaloRQSplineFrEIA`` part of ``vit4hep_tpu/models/bijectors.py``).

Every block has ``forward(x, c) -> (y, logdet)`` and ``inverse(y, c) ->
(x, logdet)``; :class:`FlowChain` runs its blocks in order forward and in
reverse order inverse, adding the log-determinants. The coupling block's
inverse (sampling) goes through ``ops/fused_spline.fused_binned_rqs_inverse``
(kernel K4) when ``fused_spline`` is set; its forward (likelihood)
direction always runs the composed spline of ``ops/rqs.py``. The other
coupling types (``SimpleRQSCouplingBlock``, ``NFlowsRQSCouplingBlock``,
``AllInOneBlock``, ``ElementwiseRQSBlock``) and ``remat_spline`` are not
ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from vit4hep_tpu_torch.ops import rqs
from vit4hep_tpu_torch.ops.fused_spline import fused_binned_rqs_inverse


class Permute(nn.Module):
    """Fixed random permutation along ``axis`` (1 = tokens, 2 = features),
    drawn as ``np.random.default_rng(seed).permutation(size)``, the JAX
    package's indices bit for bit; ``indices`` overrides it. The indices
    are buffers outside the state dict, as they are not parameters in JAX."""

    def __init__(self, size: int, axis: int = 1, seed: int = 0, indices=None):
        super().__init__()
        if indices is not None:
            perm = np.asarray(indices, np.int64)
            if sorted(perm.tolist()) != list(range(size)):
                raise ValueError(f"explicit permutation is not a permutation of 0..{size - 1}")
        else:
            perm = np.random.default_rng(seed).permutation(size)
        self.axis = axis
        self.register_buffer("perm", torch.from_numpy(perm), persistent=False)
        self.register_buffer("perm_inv", torch.from_numpy(np.argsort(perm)), persistent=False)

    def forward(self, x, c=None):
        return torch.index_select(x, self.axis, self.perm), 0.0

    def inverse(self, y, c=None):
        return torch.index_select(y, self.axis, self.perm_inv), 0.0


def _interleave(y1, y2, axis):
    """Undo the even/odd split: y[..., ::2] = y1, y[..., 1::2] = y2 along ``axis``."""
    shape = list(y1.shape)
    shape[axis] *= 2
    return torch.stack([y1, y2], dim=axis + 1).reshape(shape)


class BinnedRQSCouplingBlock(nn.Module):
    """Two-sided RQS coupling on a predicted domain with affine tails, over
    token sequences (B, T, P): ``spatial=False`` splits the tokens even/odd,
    ``spatial=True`` the features. Each side's subnet sees the passive half
    and the condition and predicts ``rqs.n_params(bins, identity_tails)``
    parameters per transformed scalar."""

    def __init__(self, subnet_ctor: Callable[[int], Any], bins: int = 10,
                 min_bin_sizes=(0.01, 0.01), default_domain=(-15.0, 15.0, -15.0, 15.0),
                 identity_tails: bool = False, domain_clamping: float | None = None,
                 spatial: bool = False, fused_spline: bool = False, remat_spline: bool = False):
        super().__init__()
        if remat_spline:
            raise NotImplementedError("remat_spline (cINN training) is not ported yet "
                                      "(ROADMAP.md queue 1, cINN)")
        self.bins = int(bins)
        self.min_bin_sizes = tuple(float(v) for v in min_bin_sizes)
        self.default_domain = tuple(float(v) for v in default_domain)
        self.identity_tails = bool(identity_tails)
        self.domain_clamping = None if domain_clamping is None else float(domain_clamping)
        self.spatial = bool(spatial)
        self.fused_spline = bool(fused_spline)
        self.n_params = rqs.n_params(self.bins, self.identity_tails)
        self.subnet1 = subnet_ctor(self.n_params)
        self.subnet2 = subnet_ctor(self.n_params)

    def _split(self, x):
        return (x[:, :, 0::2], x[:, :, 1::2]) if self.spatial else (x[:, 0::2], x[:, 1::2])

    def _apply_spline(self, subnet, active, passive, c, rev):
        theta = subnet(passive, c)  # (B, T_half, scalars_per_token * n_params)
        b = active.shape[0]
        flat = active.reshape(b, -1)
        theta = theta.reshape(b, flat.shape[1], self.n_params)
        spline = (self.bins, self.min_bin_sizes, self.default_domain, self.identity_tails,
                  self.domain_clamping)
        if rev and self.fused_spline:
            y, logdet = fused_binned_rqs_inverse(flat, theta, *spline)
        else:
            y, logdet = rqs.binned_rqs(flat, rqs.binned_constrain(theta, *spline), rev=rev)
        return y.reshape(active.shape), logdet

    def _run(self, x, c, rev):
        x1, x2 = self._split(x)
        if not rev:
            y1, j1 = self._apply_spline(self.subnet1, x1, x2, c, False)
            y2, j2 = self._apply_spline(self.subnet2, x2, y1, c, False)
        else:
            y2, j2 = self._apply_spline(self.subnet2, x2, x1, c, True)
            y1, j1 = self._apply_spline(self.subnet1, x1, y2, c, True)
        return _interleave(y1, y2, 2 if self.spatial else 1), j1 + j2

    def forward(self, x, c):
        return self._run(x, c, rev=False)

    def inverse(self, y, c):
        return self._run(y, c, rev=True)


class FlowChain(nn.Module):
    """Invertible blocks sharing one condition: ``forward`` in order,
    ``inverse`` in reverse order, adding up log|det J|."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, c):
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for block in self.blocks:
            x, j = block(x, c)
            logdet = logdet + j
        return x, logdet

    def inverse(self, z, c):
        logdet = torch.zeros(z.shape[0], dtype=z.dtype, device=z.device)
        for block in reversed(self.blocks):
            z, j = block.inverse(z, c)
            logdet = logdet + j
        return z, logdet
