"""CaloGAN shape model (port of ``vit4hep_tpu/models/calogan.py``).

A CFM over CaloGAN's three calorimeter layers (1x96x3, 1x12x12 and 1x6x12
grids stored flat as 288 + 144 + 72 voxels), patched section by section
with one patch shape per section into one token sequence
(``ops/patching.MultiSectionPatcher``); the net's ``num_patches`` comes from
the config, as in JAX. Loss and sampler are the CFM base's.
"""

from __future__ import annotations

from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.ops import patching


class CaloGANCFM(CFM):
    """CFM over (B, C, sum(list_edges)) showers with per-section patches."""

    def __init__(self, net, list_shape, list_edges, list_patch_shape, shape=None, in_channels=1,
                 time_distribution="uniform", trajectory="linear", odeint_kwargs=None, **kwargs):
        total = sum(int(e) for e in list_edges)
        super().__init__(net, shape if shape is not None else [total], time_distribution,
                         trajectory, odeint_kwargs, **kwargs)
        self.in_channels = int(in_channels)
        self.patcher = patching.MultiSectionPatcher(list_shape, list_edges, list_patch_shape,
                                                    self.in_channels)
        self.flat_voxels = total

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.in_channels, self.flat_voxels)

    def to_patches(self, x):
        return self.patcher.to_patches(x)

    def from_patches(self, x):
        return self.patcher.from_patches(x)

    def _net_args(self, x, t, c):
        return (self.to_patches(x), t, c)

    def _net_out(self, z, x_shape):
        return self.from_patches(z)

    def token_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.patcher.total_patches, self.patcher.patch_dim)
