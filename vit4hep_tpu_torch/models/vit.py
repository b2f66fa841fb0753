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
``fused_block: true`` and ``"hybrid"`` route as in JAX (``checkpoint_grads``
wins over both and keeps the composed path): with ``fused_stack: true`` and
a fitting group (``_fit_group``) the embedder, every block and the
FinalLayer run through ``ops/fused_dit_block.fused_vit_forward`` -- K2v
without gradients (also ``"sample"`` through :func:`sampling_variant`);
with gradients K5a's residual-saving forward, then per block K5b's
backward (``true``) or the plain residual backward on bf16 multiplicands
(``"hybrid"``). With ``fused_stack: false``, or a group of 0, the embedder
and the FinalLayer stay composed and each block runs the per-block kernel
K2b (``fused_dit_block``), whose backward is K5c. When training, the
kernels take the f32 weights (``lin.weight.t()``), so that gradients reach
the parameters; they cast to bf16 inside. The per-block adaLN products
stay plain PyTorch, as they sit outside the Pallas kernels in JAX. On the
card this tier now trains faster than the composed path at ds2: 37.8-44.6
against 25.9-26.2 steps per second (step interior, batch 64; PERF.md §5),
its step then held by the host (about half of it idle on the card).
``causal_attn: true`` (the reference's layer-causal ViT) reaches the masked
kernels on every path. The (T, T) mask is built once, as a non-persistent
buffer that follows the net to its device (the state dict does not
change), not on every forward.

The composed path takes the ViT's own knobs as JAX does: ``attn_impl``
(``auto``: K1 from 128 tokens; ``vmem``: K8, ``ops/vmem_attention``;
``flash``: K6, ``ops/flash_qkv_attention``; ``xla``: plain; ``auto`` and
``flash`` past K6's bound, 10,752 tokens at hidden 480: K7,
``ops/flash_attention``) and
``fused_mlp: true`` (each block's MLP half through K9,
``ops/fused_mlp.fused_mlp_half``, whose backward is the plain VJP). The
fused tier ignores both, as in JAX: ``fused_block: sample`` serves through
K2v whatever they say.

``ViT1D`` is the cINN coupling subnet: no time input, a 1-D learnable
positional embedding over ``prod_num_patches`` tokens, and ``x_out``
outputs per patch value. It runs the composed path, whose attention reaches
K1 from 128 tokens as in JAX; its ``fused_block`` twin (K2v over a ViT1D)
is not ported yet and raises. Not ported yet either: the fine-tuning
mappers and the fixed sin-cos positional embeddings.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import warnings

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vit4hep_tpu_torch.ops import fused_dit_block as fdb
from vit4hep_tpu_torch.ops import pos_embed as pe_ops
from vit4hep_tpu_torch.ops.attention import qkv_attention
from vit4hep_tpu_torch.ops.fused_mlp import fused_mlp_half

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
    """adaLN-Zero transformer block. With ``fused_mlp`` its MLP half runs
    through ``ops/fused_mlp.fused_mlp_half`` (kernel K9) on the same
    ``mlp.fc1``/``mlp.fc2`` parameters, as JAX's ``FusedMlpHalf`` keeps
    ``MlpBlock``'s param tree."""

    def __init__(self, hidden, num_heads, mlp_ratio=4.0, attn_impl="auto", fused_mlp=False):
        super().__init__()
        self.fused_mlp = fused_mlp
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), _xavier_linear(hidden, 6 * hidden, zero=True))
        self.attn = Attention(hidden, num_heads, attn_impl)
        self.mlp = MlpBlock(hidden, int(hidden * mlp_ratio))

    def forward(self, x, c, mask=None):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.adaLN_modulation(c).chunk(6, dim=-1)
        x = x + gate_msa[:, None, :] * self.attn(modulate(_ln(x), shift_msa, scale_msa), mask)
        if self.fused_mlp:
            fc1, fc2 = self.mlp.fc1, self.mlp.fc2
            return fused_mlp_half(x, shift_mlp, scale_mlp, gate_mlp, fc1.weight.t(), fc1.bias,
                                  fc2.weight.t(), fc2.bias)
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
    if p.compute_dtype not in ("float32", "fp32"):
        raise NotImplementedError("the port's ViT runs in float32")


def _attn_mask(p: ViTParams):
    """The layer-causal (T, T) bool mask when ``causal_attn`` is set, else
    None (also for ``dim != 3``, which the forward refuses, as JAX does)."""
    if not p.causal_attn or p.dim != 3:
        return None
    return torch.from_numpy(pe_ops.layer_causal_mask(p.num_patches[0]))


def _checked_mask(net):
    """The net's mask buffer for a forward."""
    if net.cfg.causal_attn and net.cfg.dim != 3:
        raise ValueError("A layer-causal attention mask should only be used in 3d")
    return net.attn_mask


def _fit_group(p: ViTParams, n: int) -> int:
    """JAX's ``_fit_group``: the largest group, halving down from
    ``fused_group`` (each candidate snapped with ``safe_group``), whose TPU
    block-stack VMEM estimate fits 98 MiB; 0 when none does (the per-block
    kernel then runs). A TPU budget, kept so that both packages route a
    configuration alike."""
    mlp_hidden = int(p.hidden_dim * p.mlp_ratio)
    g, tried = max(1, int(p.fused_group)), set()
    while g >= 1:
        eff = fdb.safe_group(g, n)
        if eff not in tried:
            tried.add(eff)
            if fdb.stack_vmem_estimate(n, p.hidden_dim, mlp_hidden, p.depth, p.num_heads,
                                       eff) <= 98 * 1024 * 1024:
                return eff
        g //= 2
    return 0


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
            DiTBlock(h, p.num_heads, p.mlp_ratio, p.attn_impl, p.fused_mlp)
            for _ in range(p.depth))
        self.final_layer = FinalLayer(h, p.out_channels * p.patch_dim)
        self._grid = [torch.from_numpy(g) for g in pe_ops.create_meshgrid(p.num_patches)]
        self.register_buffer("attn_mask", _attn_mask(p), persistent=False)

    def pos_embedding(self):
        dev = self.pos_embed_freqs.device
        pos_z, pos_y, pos_x = (g.to(dev) for g in self._grid)
        return pe_ops.learnable_fourier_pos_embed_3d(self.pos_embed_freqs, pos_z, pos_y, pos_x)

    def forward(self, x, t, c):
        p = self.cfg
        x = x.float()
        cond = self.t_embedder(t) + self.c_embedder(c.float())
        mask = _checked_mask(self)
        fused = p.fused_block in (True, "hybrid") and not p.checkpoint_grads \
            and not p.pad_attn_heads
        if fused and p.fused_stack and _fit_group(p, x.shape[1]) > 0:
            return self._fused_vit(x, cond, mask)

        x = self.x_embedder(x) + self.pos_embedding()
        if fused:
            x = self._fused_blocks(x, cond, mask)
        else:
            x = _run_blocks(self.blocks, x, cond, mask, p.checkpoint_grads)
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
        if torch.is_grad_enabled():
            weights = self.kernel_weights(train=True)
        else:
            weights = self._sampling_weights
            if weights is None:
                weights = self.kernel_weights()
        wemb, bemb, *blocks, wfin, bfin = weights
        return fdb.fused_vit_forward(
            tokens.contiguous(), self.pos_embedding().contiguous(), mods.contiguous(),
            fmod.contiguous(), wemb, bemb, *blocks, wfin, bfin,
            mask, p.num_heads, float(p.hidden_dim // p.num_heads) ** -0.5, p.fused_group,
            "xla" if p.fused_block == "hybrid" else "pallas",
        )

    def _fused_blocks(self, x, cond, mask):
        """Every block through the per-block kernel K2b
        (ops/fused_dit_block.fused_dit_block; backward K5c), as JAX's
        ``_fused_block_stack`` does with ``fused_stack: false`` or a group
        of 0."""
        p = self.cfg
        if p.fused_block == "hybrid":  # shown once: the default warnings filter
            warnings.warn("fused_block: 'hybrid' selects the plain residual backward only on "
                          "the whole-ViT path; the per-block kernel (fused_stack: false, or no "
                          "fitting group) trains with its kernel backward K5c", stacklevel=2)
        b = x.shape[0]
        c_act = F.silu(cond)
        for blk in self.blocks:
            lins = (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2)
            x = fdb.fused_dit_block(
                x, blk.adaLN_modulation[1](c_act).reshape(b, 6, p.hidden_dim),
                *(w for lin in lins for w in (lin.weight.t(), lin.bias)), mask, p.num_heads,
                float(p.hidden_dim // p.num_heads) ** -0.5)
        return x

    def kernel_weights(self, train=False):
        """The weights in fused_vit_forward's layout: the embedder, the block
        weights stacked (L, ...), the FinalLayer projection; matrices (in,
        out). For sampling, in bf16 on the card (the kernels'
        multiplicands) and f32 on the CPU (the plain version's); with
        ``train``, the f32 parameters themselves, through views and stacks
        that autograd follows back to them."""
        dt = torch.bfloat16 if self.pos_embed_freqs.is_cuda and not train else torch.float32
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
            DiTBlock(h, p.num_heads, p.mlp_ratio, p.attn_impl, p.fused_mlp)
            for _ in range(p.depth))
        self.final_layer = FinalLayer(h, p.out_channels * (p.x_out or 1) * p.patch_dim)
        # arange(T) / T in float32, as JAX computes it
        self.register_buffer("_grid", torch.from_numpy(
            np.arange(n, dtype=np.float32) / np.float32(n)), persistent=False)
        self.register_buffer("attn_mask", _attn_mask(p), persistent=False)

    def pos_embedding(self):
        return pe_ops.learnable_fourier_pos_embed_1d(self.pos_embed_freqs, self._grid)

    def forward(self, x, c):
        p = self.cfg
        cond = self.c_embedder(c.float())
        mask = _checked_mask(self)
        x = _run_blocks(self.blocks, self.x_embedder(x.float()) + self.pos_embedding(), cond,
                        mask, p.checkpoint_grads)
        return self.final_layer(x, cond)


def ViT(param: dict) -> ViTNet:
    return ViTNet(ViTParams.create(param))


def ViT1D(param: dict) -> ViT1DNet:
    p = dict(param)
    p.setdefault("prod_num_patches", int(np.prod(np.asarray(p.get("num_patches", [[15, 4, 9]])))))
    return ViT1DNet(ViTParams.create(p))
