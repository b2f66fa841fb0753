"""CaloChallenge models (port of ``CaloChallengeCFM``,
``CaloChallengeCFM_DS1``, ``CaloChallengeCINN`` and ``CaloChallengeEnergyCINN``
in ``vit4hep_tpu/models/calochallenge.py``).

Shape models over single-section (L, A, R) grids (ds2, ds3, and ds1's
cINNs on the grid that ``AddAngularBins`` pads to) and ds1's multi-section
geometry (``CaloChallengeCFM_DS1``); the energy cINN over the flat
u-vector. A shape cINN's coupling blocks are binned (``CaloRQSplineFrEIA``)
or nflows splines (``CaloRQSplineNFlows``, ``OneSidedCaloRQSplineNFlows``)
with ViT1D subnets; with ``vit_kwargs.fused_block: sample`` its sampling
runs through :attr:`CaloChallengeCINN.sample_net`, the same flow with the
subnets' kernel twins (``models/vit.sampling_variant``).
"""

from __future__ import annotations

import copy
import dataclasses
import math

from vit4hep_tpu_torch.models.bijectors import (BinnedRQSCouplingBlock, FlowChain,
                                                NFlowsRQSCouplingBlock, Permute,
                                                SimpleRQSCouplingBlock)
from vit4hep_tpu_torch.models.cfm import CFM
from vit4hep_tpu_torch.models.cinn import CINN
from vit4hep_tpu_torch.models.vit import ViT1D, sampling_variant
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
    """Shape cINN over (B, C, L, A, R) voxel grids: ``nblocks`` coupling
    blocks with ViT1D subnets, each followed by a fixed permutation of the
    tokens (of the features for a spatial block). A spatial block's subnet
    sees all T tokens of P // 2 values, a token-split one T // 2 tokens of
    P."""

    _COUPLINGS = ("CaloRQSplineFrEIA", "CaloRQSplineNFlows", "OneSidedCaloRQSplineNFlows")

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
        if coupling_block not in self._COUPLINGS:
            raise ValueError(f"Unknown Coupling block type {coupling_block}")

        n_tok = int(math.prod(self.num_patches))
        p_dim = int(math.prod(self.patch_shape))
        spatial = [bool(is_spatial[i]) if is_spatial is not None else False
                   for i in range(int(nblocks))]
        cinn_kwargs = dict(cinn_kwargs or {})

        def block_ctor(i):
            def subnet(n_params):
                # x_out = spline parameters per scalar: the subnet emits
                # out_channels * x_out * patch_dim values per token
                return ViT1D(dict(vit_kwargs, x_out=n_params,
                                  patch_dim=p_dim // 2 if spatial[i] else p_dim,
                                  num_patches=[list(self.num_patches)],
                                  prod_num_patches=n_tok if spatial[i] else n_tok // 2))

            if coupling_block == "CaloRQSplineFrEIA":
                return BinnedRQSCouplingBlock(subnet_ctor=subnet, spatial=spatial[i],
                                              **{"bins": 10, **cinn_kwargs})
            return NFlowsRQSCouplingBlock(subnet_ctor=subnet, spatial=spatial[i],
                                          one_sided=coupling_block.startswith("OneSided"),
                                          **cinn_kwargs)

        permutes = [(p_dim, 2) if sp else (n_tok, 1) for sp in spatial]
        self.net = _build_flow(int(nblocks), block_ctor, permutes, permutations=permutations)
        self._sample_twin = vit_kwargs.get("fused_block") == "sample"

    @property
    def sample_net(self):
        """The flow for sampling: with ``fused_block: sample`` the same flow
        (the same parameters and permutations) whose ViT1D subnets are their
        kernel twins; else the flow itself. Made at each call, so a twin
        never holds weights from before an update."""
        if not self._sample_twin:
            return self.net
        blocks = []
        for block in self.net.blocks:
            if isinstance(block, Permute):
                blocks.append(block)
                continue
            twin = copy.copy(block)
            twin._modules = {k: sampling_variant(m) for k, m in block._modules.items()}
            blocks.append(twin)
        return FlowChain(blocks)

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, self.in_channels, *self.shape)

    def to_patches(self, x):
        return patching.to_patches(x, self.patch_shape)

    def from_patches(self, x):
        return patching.from_patches(x, self.num_patches, self.patch_shape)


class CaloChallengeEnergyCINN(CINN):
    """Energy cINN over the flat u-vector (B, d), conditioned on the
    incident energy: ``nblocks`` ``RQSplineNFlows`` couplings
    (:class:`SimpleRQSCouplingBlock`, MLP subnets), each followed by a
    fixed permutation of the d features."""

    def __init__(self, shape, coupling_block, nblocks, cinn_kwargs, subnet_kwargs,
                 permutations=None, **kwargs):
        super().__init__(shape, **kwargs)
        if coupling_block != "RQSplineNFlows":
            raise ValueError(f"Unknown Coupling block type {coupling_block}")
        d = self.shape[0]
        cinn_kwargs = dict(cinn_kwargs or {})
        sub = dict(subnet_kwargs or {})
        subnet_kw = dict(hidden_channels=tuple(sub.get("hidden_channels", (128, 128))),
                         n_layers=int(sub.get("n_layers", 2)),
                         dropout=float(sub.get("dropout", 0.0)))

        def block_ctor(i):
            return SimpleRQSCouplingBlock(
                dims_in=d, num_bins=int(cinn_kwargs.get("num_bins", 10)),
                bounds_init=float(cinn_kwargs.get("bounds_init", 1.0)),
                subnet_kwargs=subnet_kw, condition_dim=self.condition_dim)

        self.net = _build_flow(int(nblocks), block_ctor, [(d, 1)] * int(nblocks),
                               permutations=permutations)
