"""DiT-style Vision Transformer backbone (port of ``vit4hep_tpu/models/vit.py``).

Parameter names follow the reference torch ViT (``x_embedder``,
``t_embedder.mlp.{0,2}``, ``c_embedder.{0,2}``, ``pos_embed_freqs``,
``blocks.<i>.{adaLN_modulation.1, attn.qkv, attn.proj, mlp.fc1, mlp.fc2}``,
``final_layer.{adaLN_modulation.1, linear}``); ``utils/jax_params.py`` maps
the JAX param tree onto them.

LayerNorms have no affine and eps 1e-6, GELU is the tanh form, adaLN and the
final projection are zero-initialised. The composed path trains: its
attention goes through ``ops/attention.qkv_attention``, whose ``auto``
dispatch runs kernel K1 (``fused_qkv_attention``, forward and backward) from
128 tokens, and ``checkpoint_grads: true`` recomputes each block in the
backward (``torch.utils.checkpoint``, the JAX ``nn.remat``).
``fused_block: true`` (and ``"sample"`` through :func:`sampling_variant`)
runs the embedder, every block and the FinalLayer through
``ops/fused_dit_block.fused_vit_forward``, forward only: the per-block adaLN
products stay plain PyTorch, as they sit outside the Pallas kernel in JAX,
and training through that path (``fused_block: true``/``"hybrid"`` with
gradients enabled) needs the K5 kernels and raises.

``ViT1D`` is the cINN coupling subnet: no time input, a 1-D learnable
positional embedding over ``prod_num_patches`` tokens, and ``x_out``
outputs per patch value. It runs the composed path, whose attention reaches
K1 from 128 tokens as in JAX; its ``fused_block`` twin (K2v over a ViT1D)
is not ported yet and raises. Not ported yet either: the fine-tuning
mappers, the fixed sin-cos positional embeddings, ``fused_mlp`` and the
block-stack / per-block kernel fallbacks (``fused_stack: false``).
"""

from __future__ import annotations

import copy
import dataclasses
import logging

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vit4hep_tpu_torch.ops import pos_embed as pe_ops
from vit4hep_tpu_torch.ops.attention import qkv_attention
from vit4hep_tpu_torch.ops.fused_dit_block import fused_vit_forward

_LN_EPS = 1e-6


def _normalize_num_patches(num_patches) -> tuple[tuple[int, int, int], ...]:
    num_patches = list(num_patches)
    if len(num_patches) > 0 and isinstance(num_patches[0], int):
        return (tuple(num_patches),)
    return tuple(tuple(sec) for sec in num_patches)


@dataclasses.dataclass(frozen=True)
class ViTParams:
    """Static architecture configuration; field names and defaults are the
    JAX ViTParams', so the shipped ``param`` dicts load unchanged."""

    dim: int = 3
    condition_dim: int = 46
    hidden_dim: int = 180
    out_channels: int = 1
    depth: int = 2
    num_heads: int = 4
    mlp_ratio: float = 2.0
    attn_drop: float = 0.0
    proj_drop: float = 0.0
    pos_embedding_coords: str = "cartesian"
    temperature: int = 10000
    learn_pos_embed: bool = True
    causal_attn: bool = False
    checkpoint_grads: bool = False
    patch_dim: int = 12
    num_patches: tuple = ((15, 4, 9),)
    prod_num_patches: int = 15 * 4 * 9
    x_out: int | None = None
    attn_impl: str = "auto"
    fused_mlp: bool = False
    fused_block: bool | str = False
    fused_stack: bool = True
    fused_group: int = 1
    pad_attn_heads: bool = False
    compute_dtype: str = "float32"
    in_patch_dim: int | None = None
    in_condition_dim: int | None = None
    out_patch_dim: int | None = None

    _IGNORED_REFERENCE_KEYS = frozenset({
        "use_torch_sdpa", "use_rotary_emb", "dropout", "attn_drop", "proj_drop",
    })

    @classmethod
    def create(cls, param: dict) -> "ViTParams":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in dict(param).items() if k in known}
        unknown = set(dict(param)) - known - cls._IGNORED_REFERENCE_KEYS
        if unknown:
            logging.getLogger("vit4hep-tpu").warning(
                "ViTParams: ignoring unknown net.param keys %s (typo?)", sorted(unknown))
        if "num_patches" in kwargs:
            kwargs["num_patches"] = _normalize_num_patches(kwargs["num_patches"])
        if "mlp_ratio" in kwargs:
            kwargs["mlp_ratio"] = float(kwargs["mlp_ratio"])
        fb = kwargs.get("fused_block", False)
        if not (isinstance(fb, bool) or fb in ("sample", "hybrid")):
            raise ValueError(
                f"fused_block must be true, false, 'sample', or 'hybrid' — got {fb!r}")
        return cls(**kwargs)

    @property
    def total_patches(self) -> int:
        return sum(int(np.prod(s)) for s in self.num_patches)


def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=_LN_EPS)


def modulate(x, shift, scale):
    """adaLN modulation."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _xavier_linear(din, dout, zero=False):
    lin = nn.Linear(din, dout)
    if zero:
        nn.init.zeros_(lin.weight)
    else:
        nn.init.xavier_uniform_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class MlpBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = _xavier_linear(dim, hidden)
        self.fc2 = _xavier_linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class Attention(nn.Module):
    """Multi-head self-attention on the qkv projection's native layout."""

    def __init__(self, hidden, num_heads, attn_impl="auto"):
        super().__init__()
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.qkv = _xavier_linear(hidden, 3 * hidden)
        self.proj = _xavier_linear(hidden, hidden)

    def forward(self, x, mask=None):
        head_dim = x.shape[-1] // self.num_heads
        out = qkv_attention(self.qkv(x), self.num_heads, mask=mask,
                            impl=self.attn_impl, scale=float(head_dim) ** -0.5)
        return self.proj(out)


class DiTBlock(nn.Module):
    """adaLN-Zero transformer block."""

    def __init__(self, hidden, num_heads, mlp_ratio=4.0, attn_impl="auto"):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _xavier_linear(hidden, 6 * hidden, zero=True))
        self.attn = Attention(hidden, num_heads, attn_impl)
        self.mlp = MlpBlock(hidden, int(hidden * mlp_ratio))

    def forward(self, x, c, mask=None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa[:, None, :] * self.attn(modulate(_ln(x), shift_msa, scale_msa), mask)
        return x + gate_mlp[:, None, :] * self.mlp(modulate(_ln(x), shift_mlp, scale_mlp))


class FinalLayer(nn.Module):
    """adaLN + zero-init output projection."""

    def __init__(self, hidden, out_dim):
        super().__init__()
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _xavier_linear(hidden, 2 * hidden, zero=True))
        self.linear = _xavier_linear(hidden, out_dim, zero=True)

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=-1)
        return self.linear(modulate(_ln(x), shift, scale))


class TimestepEmbedder(nn.Module):
    """Sinusoidal frequency embedding -> MLP."""

    def __init__(self, hidden, freq_dim=256):
        super().__init__()
        self.freq_dim = freq_dim
        self.mlp = nn.Sequential(_xavier_linear(freq_dim, hidden), nn.SiLU(),
                                 _xavier_linear(hidden, hidden))

    def forward(self, t):
        return self.mlp(pe_ops.timestep_embedding(t, self.freq_dim))


class ConditionEmbedder(nn.Sequential):
    """Dense -> SiLU -> Dense on the condition vector."""

    def __init__(self, condition_dim, hidden):
        super().__init__(_xavier_linear(condition_dim, hidden), nn.SiLU(),
                         _xavier_linear(hidden, hidden))


def _check_ported(p: ViTParams):
    if p.in_patch_dim is not None or p.in_condition_dim is not None \
            or p.out_patch_dim is not None:
        raise NotImplementedError("fine-tuning mappers are not ported yet (ROADMAP.md)")
    if not p.learn_pos_embed:
        raise NotImplementedError("fixed sin-cos positional embeddings are not ported yet")
    if p.fused_mlp:
        raise NotImplementedError("fused_mlp (kernel K9) is not ported yet (ROADMAP.md)")
    if p.compute_dtype not in ("float32", "fp32"):
        raise NotImplementedError("the port's ViT runs in float32")


def _attn_mask(p: ViTParams, device):
    """The layer-causal (T, T) mask when ``causal_attn`` is set, else None."""
    if not p.causal_attn:
        return None
    if p.dim != 3:
        raise ValueError("A layer-causal attention mask should only be used in 3d")
    return torch.from_numpy(pe_ops.layer_causal_mask(p.num_patches[0])).to(device)


def _run_blocks(blocks, x, cond, mask, checkpoint_grads):
    """The DiT blocks in order; with ``checkpoint_grads`` each is recomputed
    in the backward."""
    remat = checkpoint_grads and torch.is_grad_enabled()
    for block in blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(block, x, cond, mask, use_reentrant=False)
        else:
            x = block(x, cond, mask)
    return x


class ViTNet(nn.Module):
    """3-D voxel-patch DiT predicting the CFM velocity per patch.

    forward(x (B, T, patch_dim), t (B,) or (B, 1), c (B, condition_dim))
    -> (B, T, out_channels * patch_dim)."""

    _sampling_weights = None  # kernel_weights() of a sampling twin, made once

    def __init__(self, cfg: ViTParams):
        super().__init__()
        p = cfg
        _check_ported(p)
        self.cfg = cfg
        h = p.hidden_dim
        self.x_embedder = _xavier_linear(p.patch_dim, h)
        self.t_embedder = TimestepEmbedder(h)
        self.c_embedder = ConditionEmbedder(p.condition_dim, h)
        self.pos_embed_freqs = nn.Parameter(torch.randn(h // 6))
        self.blocks = nn.ModuleList(
            DiTBlock(h, p.num_heads, p.mlp_ratio, p.attn_impl) for _ in range(p.depth))
        self.final_layer = FinalLayer(h, p.out_channels * p.patch_dim)
        self._grid = [torch.from_numpy(g) for g in pe_ops.create_meshgrid(p.num_patches)]

    def pos_embedding(self):
        dev = self.pos_embed_freqs.device
        pos_z, pos_y, pos_x = (g.to(dev) for g in self._grid)
        return pe_ops.learnable_fourier_pos_embed_3d(self.pos_embed_freqs, pos_z, pos_y, pos_x)

    def forward(self, x, t, c):
        p = self.cfg
        x = x.float()
        cond = self.t_embedder(t) + self.c_embedder(c.float())
        mask = _attn_mask(p, self.pos_embed_freqs.device)
        if p.fused_block in (True, "hybrid") and not p.checkpoint_grads and not p.pad_attn_heads:
            if torch.is_grad_enabled():
                raise NotImplementedError(
                    f"fused_block: {p.fused_block!r} with gradients enabled needs the training "
                    "kernels K5a-c, not ported yet (ROADMAP.md queue 2); train the composed "
                    "path (fused_block: false or 'sample') or run under torch.no_grad()")
            if not p.fused_stack:
                raise NotImplementedError(
                    "fused_stack: false needs the per-block kernel (K2b), not ported yet")
            return self._fused_vit(x, cond, mask)

        x = _run_blocks(self.blocks, self.x_embedder(x) + self.pos_embedding(), cond, mask,
                        p.checkpoint_grads)
        return self.final_layer(x, cond)

    def _fused_vit(self, tokens, cond, mask):
        """Embedder + pos-embed + every block + FinalLayer through
        ops/fused_dit_block.fused_vit_forward; the adaLN products of the
        conditioning run here in plain PyTorch, as in JAX."""
        p = self.cfg
        b, n, _ = tokens.shape
        c_act = F.silu(cond)
        mods = torch.stack([blk.adaLN_modulation[1](c_act).reshape(b, 6, p.hidden_dim)
                            for blk in self.blocks], dim=1)
        fmod = self.final_layer.adaLN_modulation(cond).reshape(b, 2, p.hidden_dim)
        weights = self._sampling_weights
        if weights is None:
            weights = self.kernel_weights()
        wemb, bemb, *blocks, wfin, bfin = weights
        return fused_vit_forward(
            tokens.contiguous(), self.pos_embedding().contiguous(), mods.contiguous(),
            fmod.contiguous(), wemb, bemb, *blocks, wfin, bfin,
            mask, p.num_heads, float(p.hidden_dim // p.num_heads) ** -0.5, p.fused_group,
        )

    def kernel_weights(self):
        """The weights in fused_vit_forward's layout: the embedder, the block
        weights stacked (L, ...), the FinalLayer projection; matrices (in,
        out), in bf16 on the card (the kernels' multiplicands) and f32 on the
        CPU (the plain version's)."""
        dt = torch.bfloat16 if self.pos_embed_freqs.is_cuda else torch.float32
        mat = lambda lin: lin.weight.t().to(dt).contiguous()  # noqa: E731
        blocks = []  # wqkv, bqkv, wout, bout, w1, b1, w2, b2
        for lins in zip(*((k.attn.qkv, k.attn.proj, k.mlp.fc1, k.mlp.fc2) for k in self.blocks)):
            blocks += [torch.stack([mat(lin) for lin in lins]),
                       torch.stack([lin.bias for lin in lins])]
        return (mat(self.x_embedder), self.x_embedder.bias, *blocks,
                mat(self.final_layer.linear), self.final_layer.linear.bias)


def sampling_variant(net):
    """The forward-only twin of a net whose config requests ``fused_block:
    sample``: the same parameters (a shallow copy shares them), with the
    kernel path enabled. Sampling does not change the weights, so the twin
    lays them out for the kernels once (``kernel_weights``), not on every
    net eval; a twin made before a weight update is stale. Other nets are
    returned as they are."""
    cfg = getattr(net, "cfg", None)
    if getattr(cfg, "fused_block", None) == "sample":
        kw = {"fused_block": True}
        if any(f.name == "checkpoint_grads" for f in dataclasses.fields(cfg)):
            kw["checkpoint_grads"] = False
        twin = copy.copy(net)
        twin.cfg = dataclasses.replace(cfg, **kw)
        with torch.no_grad():
            twin._sampling_weights = twin.kernel_weights()
        return twin
    return net


class ViT1DNet(nn.Module):
    """ViT with a 1-D positional embedding and no time input: the coupling
    subnet of the cINN flow.

    forward(x (B, T, patch_dim), c (B, condition_dim))
    -> (B, T, out_channels * x_out * patch_dim)."""

    def __init__(self, cfg: ViTParams):
        super().__init__()
        p = cfg
        _check_ported(p)
        if p.fused_block is not False:
            raise NotImplementedError(
                f"fused_block: {p.fused_block!r} in a ViT1D needs the whole-ViT kernel (K2v) over "
                "the 1-D subnet, not ported yet (ROADMAP.md queue 1, cINN)")
        self.cfg = cfg
        h = p.hidden_dim
        n = p.prod_num_patches
        self.x_embedder = _xavier_linear(p.patch_dim, h)
        self.c_embedder = ConditionEmbedder(p.condition_dim, h)
        self.pos_embed_freqs = nn.Parameter(torch.randn(h // 2))
        self.blocks = nn.ModuleList(
            DiTBlock(h, p.num_heads, p.mlp_ratio, p.attn_impl) for _ in range(p.depth))
        self.final_layer = FinalLayer(h, p.out_channels * (p.x_out or 1) * p.patch_dim)
        # arange(T) / T in float32, as JAX computes it
        self.register_buffer("_grid", torch.from_numpy(
            np.arange(n, dtype=np.float32) / np.float32(n)), persistent=False)

    def pos_embedding(self):
        return pe_ops.learnable_fourier_pos_embed_1d(self.pos_embed_freqs, self._grid)

    def forward(self, x, c):
        p = self.cfg
        cond = self.c_embedder(c.float())
        mask = _attn_mask(p, self.pos_embed_freqs.device)
        x = _run_blocks(self.blocks, self.x_embedder(x.float()) + self.pos_embedding(), cond,
                        mask, p.checkpoint_grads)
        return self.final_layer(x, cond)


def ViT(param: dict) -> ViTNet:
    return ViTNet(ViTParams.create(param))


def ViT1D(param: dict) -> ViT1DNet:
    p = dict(param)
    p.setdefault("prod_num_patches", int(np.prod(np.asarray(p.get("num_patches", [[15, 4, 9]])))))
    return ViT1DNet(ViTParams.create(p))
