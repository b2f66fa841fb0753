"""Voxel-grid <-> patch-token conversions (port of ``vit4hep_tpu/ops/patching.py``).

Single-section 3-D grids (ds2, ds3) and multi-section grids stored
concatenated on a flat voxel axis (:class:`MultiSectionPatcher`: ds1's
sections with one shared patch shape; CaloGAN's per-section patch shapes;
CaloHadronic). The token order is the JAX package's, bit for bit: the same
einops patterns, the sections' tokens concatenated in order.
"""

from __future__ import annotations

import math

import torch
from einops import rearrange


def to_patches(x, patch_shape):
    """(B, C, L, A, R) -> (B, T, patch_dim) with T = (L/p1)(A/p2)(R/p3),
    patch_dim = p1*p2*p3*C."""
    p1, p2, p3 = patch_shape
    return rearrange(x, "b c (l p1) (a p2) (r p3) -> b (l a r) (p1 p2 p3 c)", p1=p1, p2=p2, p3=p3)


def from_patches(x, num_patches, patch_shape):
    """(B, T, patch_dim) -> (B, C, L, A, R)."""
    l, a, r = num_patches
    p1, p2, p3 = patch_shape
    return rearrange(
        x,
        "b (l a r) (p1 p2 p3 c) -> b c (l p1) (a p2) (r p3)",
        l=l, a=a, r=r, p1=p1, p2=p2, p3=p3,
    )


def check_divisible(shape, patch_shape):
    for i, (s, p) in enumerate(zip(shape, patch_shape)):
        if s % p != 0:
            raise AssertionError(
                f"Input size ({s}) should be divisible by patch size ({p}) in axis {i}."
            )


class MultiSectionPatcher:
    """Patching over a calorimeter made of several (L, A, R) sections that
    are stored concatenated along a flat voxel axis.

    ``list_shape``: each section's 3-D voxel shape; ``list_edges``: each
    section's flat voxel count (L * A * R), which splits the input;
    ``patch_shapes``: one patch shape shared by all sections, or one per
    section (CaloGAN's ``list_patch_shape``); ``in_channels``: the channel
    count C. Every section must give the same patch dim."""

    def __init__(self, list_shape, list_edges, patch_shapes, in_channels=1):
        self.list_shape = [tuple(s) for s in list_shape]
        self.list_edges = [int(e) for e in list_edges]
        if isinstance(patch_shapes[0], int):
            patch_shapes = [tuple(patch_shapes)] * len(self.list_shape)
        self.patch_shapes = [tuple(p) for p in patch_shapes]
        self.in_channels = in_channels

        self.num_patches_per_dim = []
        self.num_patches_per_section = []
        self.patch_dims = []
        for shape, pshape in zip(self.list_shape, self.patch_shapes):
            check_divisible(shape, pshape)
            npd = tuple(s // p for s, p in zip(shape, pshape))
            self.num_patches_per_dim.append(npd)
            self.num_patches_per_section.append(math.prod(npd))
            self.patch_dims.append(math.prod(pshape) * in_channels)
        if len(set(self.patch_dims)) != 1:
            raise AssertionError(f"All sections must share one patch_dim, got {self.patch_dims}")
        self.patch_dim = self.patch_dims[0]
        self.total_patches = sum(self.num_patches_per_section)

    def to_patches(self, x):
        """(B, C, sum(edges)) -> (B, total_patches, patch_dim)."""
        out, start = [], 0
        for shape, pshape, edge in zip(self.list_shape, self.patch_shapes, self.list_edges):
            sec = x[:, :, start: start + edge].reshape(-1, self.in_channels, *shape)
            out.append(to_patches(sec, pshape))
            start += edge
        return torch.cat(out, dim=1)

    def from_patches(self, x):
        """(B, total_patches, patch_dim) -> (B, C, sum(edges))."""
        out, start = [], 0
        for npd, pshape, n_sec in zip(self.num_patches_per_dim, self.patch_shapes,
                                      self.num_patches_per_section):
            sec = from_patches(x[:, start: start + n_sec], npd, pshape)
            out.append(sec.reshape(sec.shape[0], self.in_channels, -1))
            start += n_sec
        return torch.cat(out, dim=2)
