"""Positional and timestep embeddings (port of ``vit4hep_tpu/ops/pos_embed.py``).

The static grids are numpy constants, as in the JAX module; only the
learnable-frequency products run as tensor ops. The fixed sin-cos embeddings
(cylindrical, cartesian, 1-D) and the 1-D learnable embedding are not ported
yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def create_meshgrid(num_patches: tuple[tuple[int, int, int], ...]):
    """Concatenated per-section (L, A, R) grids; the layer grid is normalized
    over the total layer count of all sections.

    Returns (pos_z, pos_y, pos_x) flat float32 numpy arrays."""
    sum_l = sum(sec[0] for sec in num_patches)
    sum_lgrid = np.arange(sum_l) / sum_l
    pos_z, pos_y, pos_x = [], [], []
    offset = 0
    for L, A, R in num_patches:
        lgrid = sum_lgrid[offset: offset + L]
        offset += L
        z, y, x = np.meshgrid(lgrid, np.arange(A) / A, np.arange(R) / R, indexing="ij")
        pos_z.append(z.ravel())
        pos_y.append(y.ravel())
        pos_x.append(x.ravel())
    return (
        np.concatenate(pos_z).astype(np.float32),
        np.concatenate(pos_y).astype(np.float32),
        np.concatenate(pos_x).astype(np.float32),
    )


def learnable_fourier_pos_embed_3d(freqs, pos_z, pos_y, pos_x):
    """[sin(xw), cos(xw), sin(yw), cos(yw), sin(zw), cos(zw)] -> (T, 6*|freqs|)."""
    w = freqs * (2.0 * math.pi)
    z = pos_z[:, None] * w[None, :]
    y = pos_y[:, None] * w[None, :]
    x = pos_x[:, None] * w[None, :]
    return torch.cat(
        (torch.sin(x), torch.cos(x), torch.sin(y), torch.cos(y), torch.sin(z), torch.cos(z)),
        dim=1,
    )


def timestep_embedding(t, dim, max_period=10000):
    """Sinusoidal timestep embedding, cos first. t: (B,) or (B, 1) -> (B, dim)."""
    t = t.reshape(t.shape[0], -1)[:, :1]
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.to(torch.float32) * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding


def layer_causal_mask(num_patches: tuple[int, int, int]) -> np.ndarray:
    """Boolean (T, T) mask: token q may attend to token k iff k's calorimeter
    layer index <= q's."""
    L, A, R = num_patches
    idx = np.arange(L * A * R)
    return (idx[:, None] // (A * R)) >= (idx[None, :] // (A * R))


def gaussian_fourier_projection(t, weights):
    """Fixed random-feature time encoding, sin first, with the 2*pi factor.

    t: (B, 1), weights: (embed_dim // 2,) -> (B, embed_dim)."""
    x_proj = t * weights[None, :] * (2.0 * math.pi)
    return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)
