"""CaloChallenge shape model: CFM over patched 3-D voxel grids (port of
``CaloChallengeCFM`` in ``vit4hep_tpu/models/calochallenge.py``).

Single-section (L, A, R) grids (ds2/ds3). ``CaloChallengeCFM_DS1`` and the
cINN classes are not ported yet.
"""

from __future__ import annotations

import math

from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.ops import patching


class CaloChallengeCFM(CFM):
    """CFM over (B, C, L, A, R) voxel grids, tokenized by 3-D patches."""

    def __init__(self, net, patch_shape, shape, in_channels=1, time_distribution="uniform",
                 trajectory="linear", odeint_kwargs=None, **kwargs):
        super().__init__(net, shape, time_distribution, trajectory, odeint_kwargs, **kwargs)
        self.patch_shape = tuple(int(p) for p in patch_shape)
        self.in_channels = int(in_channels)
        patching.check_divisible(self.shape, self.patch_shape)
        self.num_patches = tuple(s // p for s, p in zip(self.shape, self.patch_shape))

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.in_channels, *self.shape)

    def to_patches(self, x):
        return patching.to_patches(x, self.patch_shape)

    def from_patches(self, x):
        return patching.from_patches(x, self.num_patches, self.patch_shape)

    def _net_args(self, x, t, c):
        return (self.to_patches(x), t, c)

    def _net_out(self, z, x_shape):
        return self.from_patches(z)

    def token_shape(self, batch_size: int) -> tuple:
        t = int(math.prod(self.num_patches))
        p = int(math.prod(self.patch_shape)) * self.in_channels
        return (batch_size, t, p)
