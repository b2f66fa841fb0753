"""CaloChallenge shape models over patched 3-D voxel grids (port of
``CaloChallengeCFM``, ``CaloChallengeCFM_DS1`` and ``CaloChallengeCINN`` in
``vit4hep_tpu/models/calochallenge.py``).

Single-section (L, A, R) grids (ds2, ds3, and ds1's cINNs on the grid that
``AddAngularBins`` pads to) and ds1's multi-section geometry
(``CaloChallengeCFM_DS1``). The energy cINN (``CaloChallengeEnergyCINN``)
and the nflows coupling blocks are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import dataclasses
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


class CaloChallengeCFM_DS1(CaloChallengeCFM):
    """CFM over an irregular geometry of several sections (ds1's 5 or 7
    calorimeter layers), stored concatenated on a flat voxel axis: the
    input is (B, C, sum(list_edges)); each section is reshaped to its own
    3-D grid, patched with the shared ``patch_shape``, and the token
    sequences are concatenated (``ops/patching.MultiSectionPatcher``).

    The net is rebuilt from its config with the patcher's per-section patch
    grids as ``num_patches`` (its positional meshgrid), keeping the weights
    it was built with, as JAX rebuilds the Flax module before its
    parameters exist."""

    def __init__(self, net, list_shape, list_edges, patch_shape, shape=None, in_channels=1,
                 time_distribution="uniform", trajectory="linear", odeint_kwargs=None,
                 **kwargs):
        total = sum(int(e) for e in list_edges)
        super().__init__(net, patch_shape, shape if shape is not None else [total],
                         in_channels, time_distribution, trajectory, odeint_kwargs, **kwargs)
        self.patcher = patching.MultiSectionPatcher(list_shape, list_edges, self.patch_shape,
                                                    in_channels)
        cfg = dataclasses.replace(net.cfg, num_patches=tuple(self.patcher.num_patches_per_dim))
        if cfg != net.cfg:
            rebuilt = type(net)(cfg)
            rebuilt.load_state_dict(net.state_dict())
            self.net = rebuilt
        self.flat_voxels = total

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.in_channels, self.flat_voxels)

    def token_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.patcher.total_patches, self.patcher.patch_dim)

    def to_patches(self, x):
        return self.patcher.to_patches(x)

    def from_patches(self, x):
        return self.patcher.from_patches(x)


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
