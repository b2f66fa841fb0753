"""CaloChallenge shape models over patched 3-D voxel grids (port of
``CaloChallengeCFM`` and ``CaloChallengeCINN`` in
``vit4hep_tpu/models/calochallenge.py``).

Single-section (L, A, R) grids (ds2/ds3). ``CaloChallengeCFM_DS1``, the
energy cINN (``CaloChallengeEnergyCINN``) and the nflows coupling blocks
are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import math

from vit4hep_tpu_torch.models.bijectors import BinnedRQSCouplingBlock, FlowChain, Permute
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.cinn import CINN
from vit4hep_tpu_torch.models.vit import ViT1D
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


def _build_flow(nblocks, block_ctor, permute_sizes_axes, permutations=None):
    """[coupling, permute] x nblocks as a FlowChain; block i's permutation
    is drawn from seed i unless ``permutations`` (one index list per block)
    gives it."""
    if permutations is not None and len(permutations) != nblocks:
        raise ValueError(f"{len(permutations)} explicit permutations for {nblocks} blocks")
    blocks = []
    for i in range(nblocks):
        blocks.append(block_ctor(i))
        size, axis = permute_sizes_axes[i]
        idx = None if permutations is None else [int(j) for j in permutations[i]]
        blocks.append(Permute(size=size, axis=axis, seed=i, indices=idx))
    return FlowChain(blocks)


class CaloChallengeCINN(CINN):
    """Shape cINN over (B, C, L, A, R) voxel grids: ``nblocks`` binned-RQS
    coupling blocks (``CaloRQSplineFrEIA``) with ViT1D subnets, each
    followed by a fixed permutation of the tokens (of the features for a
    spatial block)."""

    def __init__(self, shape, patch_shape, in_channels, coupling_block, nblocks, is_spatial,
                 cinn_kwargs, vit_kwargs, permutations=None, **kwargs):
        super().__init__(shape, **kwargs)
        if isinstance(patch_shape[0], (list, tuple)):
            patch_shape = patch_shape[0]
        self.patch_shape = tuple(int(p) for p in patch_shape)
        patching.check_divisible(self.shape, self.patch_shape)
        self.num_patches = tuple(s // p for s, p in zip(self.shape, self.patch_shape))
        self.in_channels = int(in_channels)
        self.condition_dim = int(vit_kwargs.get("condition_dim", 1))
        if coupling_block in ("CaloRQSplineNFlows", "OneSidedCaloRQSplineNFlows"):
            raise NotImplementedError(f"coupling block {coupling_block} is not ported yet "
                                      "(ROADMAP.md queue 1, cINN)")
        if coupling_block != "CaloRQSplineFrEIA":
            raise ValueError(f"Unknown Coupling block type {coupling_block}")

        n_tok = int(math.prod(self.num_patches))
        p_dim = int(math.prod(self.patch_shape))
        spatial = [bool(is_spatial[i]) if is_spatial is not None else False
                   for i in range(int(nblocks))]
        cinn_kwargs = dict(cinn_kwargs or {})
        cinn_kwargs.setdefault("bins", 10)

        def block_ctor(i):
            def subnet(n_params):
                # x_out = spline parameters per scalar: the subnet emits
                # out_channels * x_out * patch_dim values per token
                return ViT1D(dict(vit_kwargs, x_out=n_params,
                                  patch_dim=p_dim // 2 if spatial[i] else p_dim,
                                  num_patches=[list(self.num_patches)],
                                  prod_num_patches=n_tok if spatial[i] else n_tok // 2))

            return BinnedRQSCouplingBlock(subnet_ctor=subnet, spatial=spatial[i], **cinn_kwargs)

        permutes = [(p_dim, 2) if sp else (n_tok, 1) for sp in spatial]
        self.net = _build_flow(int(nblocks), block_ctor, permutes, permutations=permutations)

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.in_channels, *self.shape)

    def to_patches(self, x):
        return patching.to_patches(x, self.patch_shape)

    def from_patches(self, x):
        return patching.from_patches(x, self.num_patches, self.patch_shape)
