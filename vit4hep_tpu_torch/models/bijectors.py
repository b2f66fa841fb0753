"""Invertible blocks of the conditional normalizing flow (port of
``vit4hep_tpu/models/bijectors.py``).

Every block has ``forward(x, c) -> (y, logdet)`` and ``inverse(y, c) ->
(x, logdet)``; :class:`FlowChain` runs its blocks in order forward and in
reverse order inverse, adding the log-determinants. The coupling types of
the shipped configs: ``CaloRQSplineFrEIA`` (:class:`BinnedRQSCouplingBlock`,
ViT1D subnets), ``RQSplineNFlows`` (:class:`SimpleRQSCouplingBlock`, MLP
subnets: the energy cINN), ``CaloRQSplineNFlows`` and
``OneSidedCaloRQSplineNFlows`` (:class:`NFlowsRQSCouplingBlock`, ViT1D
subnets). :class:`AllInOneBlock` and :class:`ElementwiseRQSBlock`, which no
shipped config reaches, are ported for parity of the components.

The binned coupling's inverse (sampling) goes through
``ops/fused_spline.fused_binned_rqs_inverse`` (kernel K4) when
``fused_spline`` is set; its forward (likelihood) direction always runs the
composed spline of ``ops/rqs.py``, recomputed in the backward under
``remat_spline`` (``torch.utils.checkpoint``, JAX's ``jax.checkpoint``).
The nflows blocks run the plain ``rqs.nflows_rqs`` both ways, as in JAX.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from vit4hep_tpu_torch.ops import rqs
from vit4hep_tpu_torch.ops.fused_spline import fused_binned_rqs_inverse


def _dense(din, dout, zero=False):
    """A Linear with flax ``nn.Dense``'s initialisation: LeCun normal
    (truncated at 2 std) weights, zero bias; all zero with ``zero``."""
    lin = nn.Linear(din, dout)
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        std = math.sqrt(1.0 / din) / 0.87962566103423978
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(lin.bias)
    return lin


class SubnetMLP(nn.Module):
    """ReLU MLP parameter subnet: ``n_layers`` hidden Dense layers, then a
    zero-initialised output layer, so that every coupling starts as the
    identity. ``dropout`` is accepted and not applied, as in JAX."""

    def __init__(self, in_dim: int, out_dim: int, hidden_channels: Sequence[int] = (128, 128),
                 n_layers: int = 2, dropout: float = 0.0):
        super().__init__()
        dims = [int(in_dim)] + [int(hidden_channels[i]) for i in range(n_layers)]
        self.layers = nn.ModuleList([_dense(a, b) for a, b in zip(dims, dims[1:])]
                                    + [_dense(dims[-1], out_dim, zero=True)])

    def forward(self, x):
        for lin in self.layers[:-1]:
            x = torch.relu(lin(x))
        return self.layers[-1](x)


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


def _split(x, spatial):
    """The even and odd tokens of (B, T, P), or its even and odd features
    when ``spatial``."""
    return (x[:, :, 0::2], x[:, :, 1::2]) if spatial else (x[:, 0::2], x[:, 1::2])


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
        self.remat_spline = bool(remat_spline)
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

    def _apply_spline(self, subnet, active, passive, c, rev):
        theta = subnet(passive, c)  # (B, T_half, scalars_per_token * n_params)
        b = active.shape[0]
        flat = active.reshape(b, -1)
        theta = theta.reshape(b, flat.shape[1], self.n_params)
        spline = (self.bins, self.min_bin_sizes, self.default_domain, self.identity_tails,
                  self.domain_clamping)
        if rev and self.fused_spline:
            y, logdet = fused_binned_rqs_inverse(flat, theta, *spline)
            return y.reshape(active.shape), logdet

        def composed(flat, theta):
            return rqs.binned_rqs(flat, rqs.binned_constrain(theta, *spline), rev=rev)

        if self.remat_spline and torch.is_grad_enabled():
            # keep only (flat, theta); the spline's elementwise intermediates
            # are recomputed in the backward
            y, logdet = torch.utils.checkpoint.checkpoint(composed, flat, theta,
                                                          use_reentrant=False)
        else:
            y, logdet = composed(flat, theta)
        return y.reshape(active.shape), logdet

    def _run(self, x, c, rev):
        x1, x2 = _split(x, self.spatial)
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


class SimpleRQSCouplingBlock(nn.Module):
    """Two-sided nflows RQS coupling on flat vectors (B, d) with MLP
    subnets: the ``RQSplineNFlows`` block of the energy cINN. The halves are
    the first floor(d / 2) features and the other ceil(d / 2); each side's
    subnet sees [passive half, condition]."""

    def __init__(self, dims_in: int, num_bins: int = 10, bounds_init: float = 1.0,
                 subnet_kwargs: dict | None = None, condition_dim: int = 1):
        super().__init__()
        self.num_bins = int(num_bins)
        self.bound = float(bounds_init)
        self.half1 = int(dims_in) // 2
        self.half2 = int(dims_in) - self.half1
        kw = dict(subnet_kwargs or {})
        n = 3 * self.num_bins - 1
        self.subnet1 = SubnetMLP(self.half2 + condition_dim, n * self.half1, **kw)
        self.subnet2 = SubnetMLP(self.half1 + condition_dim, n * self.half2, **kw)

    def _couple(self, subnet, active, passive, c, rev):
        inp = passive if c is None else torch.cat([passive, c], dim=-1)
        theta = subnet(inp).reshape(active.shape[0], active.shape[1], -1)
        return rqs.nflows_rqs(active, theta, self.num_bins, self.bound, rev=rev)

    def _run(self, x, c, rev):
        x1, x2 = x[:, :self.half1], x[:, self.half1:]
        if not rev:
            y1, j1 = self._couple(self.subnet1, x1, x2, c, False)
            y2, j2 = self._couple(self.subnet2, x2, y1, c, False)
        else:
            y2, j2 = self._couple(self.subnet2, x2, x1, c, True)
            y1, j1 = self._couple(self.subnet1, x1, y2, c, True)
        return torch.cat([y1, y2], dim=1), j1 + j2

    def forward(self, x, c):
        return self._run(x, c, rev=False)

    def inverse(self, y, c):
        return self._run(y, c, rev=True)


class NFlowsRQSCouplingBlock(nn.Module):
    """nflows RQS coupling over token sequences (B, T, P) with ViT1D
    subnets: the ``CaloRQSplineNFlows`` block, or with ``one_sided`` the
    ``OneSidedCaloRQSplineNFlows`` one, which transforms only the second
    (odd) half given the first, through ``subnet1``. Tokens are split
    even/odd, or the features when ``spatial``."""

    def __init__(self, subnet_ctor: Callable[[int], Any], num_bins: int = 10,
                 bounds_init: float = 1.0, spatial: bool = False, one_sided: bool = False):
        super().__init__()
        self.num_bins = int(num_bins)
        self.bound = float(bounds_init)
        self.spatial = bool(spatial)
        self.one_sided = bool(one_sided)
        self.subnet1 = subnet_ctor(3 * self.num_bins - 1)
        if not self.one_sided:
            self.subnet2 = subnet_ctor(3 * self.num_bins - 1)

    def _couple(self, subnet, active, passive, c, rev):
        theta = subnet(passive, c)
        b = active.shape[0]
        flat = active.reshape(b, -1)
        theta = theta.reshape(b, flat.shape[1], 3 * self.num_bins - 1)
        y, logdet = rqs.nflows_rqs(flat, theta, self.num_bins, self.bound, rev=rev)
        return y.reshape(active.shape), logdet

    def _run(self, x, c, rev):
        x1, x2 = _split(x, self.spatial)
        ax = 2 if self.spatial else 1
        if self.one_sided:
            y2, j = self._couple(self.subnet1, x2, x1, c, rev)
            return _interleave(x1, y2, ax), j
        if not rev:
            y1, j1 = self._couple(self.subnet1, x1, x2, c, False)
            y2, j2 = self._couple(self.subnet2, x2, y1, c, False)
        else:
            y2, j2 = self._couple(self.subnet2, x2, x1, c, True)
            y1, j1 = self._couple(self.subnet1, x1, y2, c, True)
        return _interleave(y1, y2, ax), j1 + j2

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


class AllInOneBlock(nn.Module):
    """Affine coupling, global affine (ActNorm) and permutation in one block
    on flat vectors (B, d): ``y = R (Psi(s_g) * Coupling(x) + t_g)``, with
    the soft-clamped affine coupling u2 = x2 exp(alpha tanh(s(x1))) + t(x1)
    of the subnet's output scaled by 0.1, its volume-preserving GIN variant
    (the scales centred; no ActNorm), and a hard permutation or, with
    ``permute_soft``, a rotation drawn from SO(d); both drawn from
    ``np.random.default_rng(seed)`` as JAX draws them. ``subnet_ctor(in,
    out)`` builds the subnet (default :class:`SubnetMLP`)."""

    def __init__(self, dims_in: int, subnet_ctor: Callable[[int, int], Any] | None = None,
                 affine_clamping: float = 2.0, gin_block: bool = False,
                 global_affine_init: float = 1.0, permute_soft: bool = False, seed: int = 0,
                 condition_dim: int = 0):
        super().__init__()
        d = int(dims_in)
        self.split1, self.split2 = d // 2, d - d // 2
        self.affine_clamping = float(affine_clamping)
        self.gin_block = bool(gin_block)
        ctor = subnet_ctor or (lambda din, dout: SubnetMLP(din, dout))
        self.subnet = ctor(self.split1 + condition_dim, 2 * self.split2)
        rng = np.random.default_rng(seed)
        if permute_soft:
            q, r = np.linalg.qr(rng.normal(size=(d, d)))
            q = q * np.sign(np.diag(r))
            if np.linalg.det(q) < 0:
                q[:, 0] = -q[:, 0]
            w = q
        else:
            w = np.zeros((d, d))
            for i, j in enumerate(rng.permutation(d)):
                w[i, j] = 1.0
        self.register_buffer("w_perm", torch.tensor(w, dtype=torch.float32), persistent=False)
        init_pre = 2.0 * np.log(np.exp(0.5 * 10.0 * global_affine_init) - 1)
        self.global_scale = nn.Parameter(torch.full((1, d), float(init_pre)))
        self.global_offset = nn.Parameter(torch.zeros(1, d))

    def _scale(self):
        return 0.1 * 2.0 * rqs._softplus(0.5 * self.global_scale)

    def _affine(self, x2, a, rev):
        a = a * 0.1
        s = self.affine_clamping * torch.tanh(a[:, :self.split2])
        if self.gin_block:
            s = s - s.mean(1, keepdim=True)
        t = a[:, self.split2:]
        if rev:
            return (x2 - t) * torch.exp(-s), -s.sum(1)
        return x2 * torch.exp(s) + t, s.sum(1)

    def _subnet(self, x1, c):
        return self.subnet(x1 if c is None else torch.cat([x1, c], 1))

    def forward(self, x, c=None):
        x1, x2 = x[:, :self.split1], x[:, self.split1:]
        y2, logdet = self._affine(x2, self._subnet(x1, c), rev=False)
        y = torch.cat([x1, y2], dim=1)
        if not self.gin_block:
            scale = self._scale()
            y = y * scale + self.global_offset
            logdet = logdet + torch.log(scale).sum()
        return y @ self.w_perm.T, logdet

    def inverse(self, y, c=None):
        y = y @ self.w_perm  # w_perm is orthogonal: its inverse is its transpose
        logdet = torch.zeros(y.shape[0], dtype=y.dtype, device=y.device)
        if not self.gin_block:
            scale = self._scale()
            y = (y - self.global_offset) / scale
            logdet = logdet - torch.log(scale).sum()
        x1, y2 = y[:, :self.split1], y[:, self.split1:]
        x2, j = self._affine(y2, self._subnet(x1, c), rev=True)
        return torch.cat([x1, x2], dim=1), logdet + j


class ElementwiseRQSBlock(nn.Module):
    """A binned RQS on every dimension of (B, d), its parameters predicted
    from the condition by a :class:`SubnetMLP` (``condition_dim > 0``) or
    free (``spline_parameters``, zero-initialised) without one."""

    def __init__(self, dims_in: int, condition_dim: int = 0, bins: int = 10,
                 min_bin_sizes=(0.01, 0.01), default_domain=(-15.0, 15.0, -15.0, 15.0),
                 identity_tails: bool = False, domain_clamping: float | None = None,
                 subnet_kwargs: dict | None = None):
        super().__init__()
        self.dims_in = int(dims_in)
        self.condition_dim = int(condition_dim)
        self.spline = (int(bins), tuple(float(v) for v in min_bin_sizes),
                       tuple(float(v) for v in default_domain), bool(identity_tails),
                       None if domain_clamping is None else float(domain_clamping))
        self.n_params = rqs.n_params(int(bins), bool(identity_tails))
        if self.condition_dim > 0:
            self.subnet = SubnetMLP(self.condition_dim, self.dims_in * self.n_params,
                                    **dict(subnet_kwargs or {}))
        else:
            self.spline_parameters = nn.Parameter(torch.zeros(self.dims_in * self.n_params))

    def _params(self, c, batch):
        if self.condition_dim > 0:
            theta = self.subnet(c)
        else:
            theta = self.spline_parameters.expand(batch, -1)
        return rqs.binned_constrain(theta.reshape(-1, self.dims_in, self.n_params), *self.spline)

    def forward(self, x, c=None):
        return rqs.binned_rqs(x, self._params(c, x.shape[0]), rev=False)

    def inverse(self, y, c=None):
        return rqs.binned_rqs(y, self._params(c, y.shape[0]), rev=True)
