"""Positional and timestep embeddings (port of ``vit4hep_tpu/ops/pos_embed.py``).

The static grids are numpy constants, as in the JAX module; only the
learnable-frequency products run as tensor ops. The fixed sin-cos
embeddings (``learn_pos_embed: false``: cylindrical, cartesian, 1-D) are
numpy constants too, computed as the JAX package computes them (the 1-D
grid keeps its halved token count).
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


def learnable_fourier_pos_embed_1d(freqs, grid):
    """[sin(pw), cos(pw)] over the 1-D grid p -> (T, 2*|freqs|) (the ViT1D subnet's)."""
    pos = grid[:, None] * (freqs * (2.0 * math.pi))[None, :]
    return torch.cat((torch.sin(pos), torch.cos(pos)), dim=1)


def get_sincos_pos_embed(pos_embedding_coords, num_patches, hidden_dim, dim, temperature=10000):
    """The fixed embedding of a ViT with ``learn_pos_embed: false``: (T,
    hidden) float32 numpy, by coordinates and the ViT's ``dim``."""
    if pos_embedding_coords == "cylindrical" and dim == 3:
        return get_3d_cylindrical_sincos_pos_embed(num_patches, hidden_dim, temperature)
    if pos_embedding_coords == "cartesian" and dim == 3:
        return get_3d_cartesian_sincos_pos_embed(num_patches, hidden_dim, temperature)
    if dim == 1:
        return get_1d_sincos_pos_embed(num_patches, hidden_dim, temperature)
    raise ValueError(f"No sincos embedding for coords={pos_embedding_coords}, dim={dim}")


def get_1d_sincos_pos_embed(num_patches, dim, temperature=10000):
    """[sin(x omega), cos(x omega)] over x = arange(T') / T' with T' half the
    product of ``num_patches`` (the reference's halving, kept)."""
    prod_patches = int(math.prod(np.asarray(num_patches).ravel()) / 2)
    x = np.arange(prod_patches) / prod_patches
    fourier_dim = dim // 2
    if fourier_dim < 2:  # omega's normalization divides by fourier_dim - 1
        raise ValueError(f"hidden_dim {dim} too small for a 1-D sincos embedding")
    omega = 1.0 / (temperature ** (np.arange(fourier_dim) / (fourier_dim - 1)))
    args = x[:, None] * omega[None, :]
    return np.concatenate((np.sin(args), np.cos(args)), axis=1).astype(np.float32)


def get_3d_cylindrical_sincos_pos_embed(num_patches, dim, temperature=10000):
    """The (L, A, R) grid, each axis over [0, 1)."""
    L, A, R = num_patches
    z, y, x = np.meshgrid(np.arange(L) / L, np.arange(A) / A, np.arange(R) / R, indexing="ij")
    return _sincos_3d(z, y, x, dim, temperature)


def get_3d_cartesian_sincos_pos_embed(num_patches, dim, temperature=10000):
    """Polar (depth, angle, radius) -> cartesian (depth, y, x) before embedding."""
    L, A, R = num_patches
    z, alpha, r = np.meshgrid(np.arange(L) / L, np.arange(A) * (2 * math.pi / A),
                              np.arange(R) / R, indexing="ij")
    return _sincos_3d(z, r * np.sin(alpha), r * np.cos(alpha), dim, temperature)


def _sincos_3d(z, y, x, dim, temperature):
    fourier_dim = dim // 6
    if fourier_dim < 2:
        raise ValueError(f"hidden_dim {dim} too small for a 3-D sincos embedding")
    omega = 1.0 / (temperature ** (np.arange(fourier_dim) / (fourier_dim - 1)))
    z, y, x = (a.ravel()[:, None] * omega[None, :] for a in (z, y, x))
    return np.concatenate(
        (np.sin(x), np.cos(x), np.sin(y), np.cos(y), np.sin(z), np.cos(z)), axis=1
    ).astype(np.float32)


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
