"""Voxel-grid <-> patch-token conversions (port of ``vit4hep_tpu/ops/patching.py``).

Single-section 3-D grids only; ``MultiSectionPatcher`` (ds1, CaloGAN,
CaloHadronic) is not ported yet. The token order is the JAX package's, bit
for bit: the same einops patterns.
"""

from __future__ import annotations

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
