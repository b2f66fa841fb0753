"""CFM energy network: encoder-decoder transformer over u-vector components
(port of ``vit4hep_tpu/models/energy_transformer.py``).

Parameter names follow the reference torch ``ParallelTransformer`` (a
post-LayerNorm ``nn.Transformer``): ``time_embed.1``, ``x_embed``,
``pos_embed_x``, ``c_embed``, ``pos_embed_c``,
``transformer.{encoder,decoder}.layers.<i>.{self_attn,multihead_attn,
linear1,linear2,norm1,norm2,norm3}``, ``transformer.*.norm`` and the head
``layers.0`` / ``layers.2``. ``utils/jax_params.py`` maps the JAX param tree
onto these names. Attention is the port's own plain attention, not
``nn.MultiheadAttention``, which may route to a fused library kernel.

``fused_block: true`` (and ``"sample"`` through :func:`sampling_variant`)
runs the decoder stack + head as one hand-written kernel per batch element
(``ops/fused_energy_decoder.py``), valid when the encoder memory collapses
to one token: ``dims_c == 1``, or no condition. With gradients enabled,
``fused_block: true`` trains through that kernel's forward, whose backward
is the VJP of the plain decoder (as in JAX); the ds2 default
(``fused_block: sample``) trains the composed layers.

``compute_dtype: bfloat16`` (or ``bf16``) computes as JAX's ``dtype=``
does: parameters f32, every Dense (``utils.misc.Dense`` /
``utils.misc.dense``) and the embeddings in bf16, the LayerNorms' statistics
in f32 with a bf16 result (``utils.misc.layer_norm``), the activations as
JAX's formulas op by op (``utils.misc.silu``, ``gelu_tanh``), the input, the time
features and the condition cast to bf16, the attention through
``dot_product_attention`` (f32 logits, the weights rounded to bf16), the
output cast to f32. The decoder kernel takes the bf16-valued target and time
features cast to f32, and the per-layer cross terms in f32 from
``memory[:, 0]`` cast to f32 (``vit4hep_tpu/models/energy_transformer.py:
352-400``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit4hep_tpu_torch.models.vit import current_sampling_weights
from vit4hep_tpu_torch.ops.attention import dot_product_attention
from vit4hep_tpu_torch.ops.fused_energy_decoder import fused_energy_decoder
from vit4hep_tpu_torch.ops.pos_embed import gaussian_fourier_projection
from vit4hep_tpu_torch.utils.misc import (Dense, SiLU, compute_dtype, dense, f32, gelu_tanh,
                                          layer_norm, set_compute_dtype, silu, to_dtype)

_LN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class EnergyTransformerParams:
    """Defaults track the reference's ParallelTransformer and the JAX class."""

    dims_in: int = 46
    dims_c: int = 1
    dim_embedding: int = 180
    nhead: int = 4
    num_encoder_layers: int = 2
    num_decoder_layers: int = 4
    dim_feedforward: int = 256
    dropout: float = 0.0
    activation: str = "relu"
    embeds: bool = False
    encode_t_scale: float = 30.0
    encode_t_dim: int = 64
    attn_impl: str = "xla"
    compute_dtype: str = "float32"
    # frozen Gaussian-Fourier time-projection weights (encode_t_dim // 2);
    # None = the JAX package's deterministic constant
    fourier_w: tuple | None = None
    # False = composed; True = decoder kernel; "sample" = sampling twin only
    fused_block: Any = False
    # the TPU kernel's batch group; accepted, does not change the CUDA work
    fused_group: int = 16

    @classmethod
    def create(cls, param: dict) -> "EnergyTransformerParams":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in dict(param).items() if k in known}
        if kwargs.get("fourier_w") is not None:
            kwargs["fourier_w"] = tuple(float(w) for w in kwargs["fourier_w"])
        return cls(**kwargs)

    def __post_init__(self):
        if self.embeds and self.encode_t_dim != self.dim_embedding:
            raise ValueError(
                f"embeds=True requires encode_t_dim ({self.encode_t_dim}) "
                f"== dim_embedding ({self.dim_embedding})"
            )

    @property
    def d_model(self) -> int:
        return 2 * self.dim_embedding if self.embeds else self.dim_embedding

    def fourier_weights(self) -> np.ndarray:
        if self.fourier_w is not None:
            return np.asarray(self.fourier_w, np.float32)
        w = np.random.default_rng(20260816).normal(size=(self.encode_t_dim // 2,))
        return (w * self.encode_t_scale).astype(np.float32)


def _activation(name: str):
    return {"relu": F.relu, "gelu": gelu_tanh, "silu": silu}[name]


class GaussianFourierProjection(nn.Module):
    """Fixed random-feature time encoding; ``W`` is a constant of the config,
    not a trained parameter, so it stays out of the state dict."""

    def __init__(self, weights: np.ndarray):
        super().__init__()
        self.register_buffer("W", torch.as_tensor(weights, dtype=torch.float32),
                             persistent=False)

    def forward(self, t):
        return gaussian_fourier_projection(f32(t.reshape(t.shape[0], 1)), self.W)


class MultiheadAttention(nn.Module):
    """q/k/v projections packed as ``in_proj_weight`` rows [q; k; v] plus
    ``out_proj`` (torch's layout). Self- and cross-attention both split the
    projections into (B, H, N, D) q, k, v for ``dot_product_attention``, as
    JAX's ``_MHA`` does for every attention of this net: ``attn_impl``
    routes alike in both packages (``fused``, the qkv-panel kernel, raises
    ``ValueError`` there too)."""

    dt = torch.float32

    def __init__(self, d_model: int, nhead: int, attn_impl: str = "xla"):
        super().__init__()
        self.nhead = nhead
        self.attn_impl = attn_impl
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q_in, kv_in, mask=None):
        """``mask``: an optional (Nq, Nk) bool, True = attend."""
        b, nq, dm = q_in.shape
        nk = kv_in.shape[1]
        hd = dm // self.nhead
        q = dense(q_in, self.in_proj_weight[:dm], self.in_proj_bias[:dm], self.dt)
        k, v = dense(kv_in, self.in_proj_weight[dm:], self.in_proj_bias[dm:], self.dt).chunk(2, -1)
        q = q.reshape(b, nq, self.nhead, hd).transpose(1, 2)
        k = k.reshape(b, nk, self.nhead, hd).transpose(1, 2)
        v = v.reshape(b, nk, self.nhead, hd).transpose(1, 2)
        out = dot_product_attention(q, k, v, mask, impl=self.attn_impl)
        return dense(out.transpose(1, 2).reshape(b, nq, dm), self.out_proj.weight,
                     self.out_proj.bias, self.dt)


def _norm(norm, x, dt):
    """An nn.LayerNorm's affine normalisation computed for ``dt``."""
    return layer_norm(x, dt, norm.eps, norm.weight, norm.bias)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (torch TransformerEncoderLayer, norm_first=False)."""

    dt = torch.float32

    def __init__(self, d_model, nhead, dim_feedforward, activation, attn_impl):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, attn_impl)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.act = _activation(activation)

    def forward(self, x):
        x = _norm(self.norm1, x + self.self_attn(x, x), self.dt)
        return _norm(self.norm2, x + self.linear2(self.act(self.linear1(x))), self.dt)


class DecoderLayer(nn.Module):
    """Post-LN decoder layer: self-attention, cross-attention, feed-forward."""

    dt = torch.float32

    def __init__(self, d_model, nhead, dim_feedforward, activation, attn_impl):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, nhead, attn_impl)
        self.multihead_attn = MultiheadAttention(d_model, nhead, attn_impl)
        self.linear1 = Dense(d_model, dim_feedforward)
        self.linear2 = Dense(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=_LN_EPS)
        self.act = _activation(activation)

    def forward(self, x, memory, self_mask=None):
        x = _norm(self.norm1, x + self.self_attn(x, x, self_mask), self.dt)
        x = _norm(self.norm2, x + self.multihead_attn(x, memory), self.dt)
        return _norm(self.norm3, x + self.linear2(self.act(self.linear1(x))), self.dt)


class _Stack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(layers[0].linear2.out_features, eps=_LN_EPS)


class _Transformer(nn.Module):
    def __init__(self, p: EnergyTransformerParams):
        super().__init__()
        args = (p.d_model, p.nhead, p.dim_feedforward, p.activation, p.attn_impl)
        self.encoder = _Stack([EncoderLayer(*args) for _ in range(p.num_encoder_layers)])
        self.decoder = _Stack([DecoderLayer(*args) for _ in range(p.num_decoder_layers)])


class ParallelTransformerNet(nn.Module):
    """forward(x (B, dims_in), t (B,) or (B, 1), condition (B, dims_c) or
    None) -> (B, dims_in) velocity."""

    _sampling_weights = None  # kernel_weights() of a sampling twin, made once
    dt = torch.float32  # the compute dtype (``compute_dtype``)

    def __init__(self, cfg: EnergyTransformerParams):
        super().__init__()
        self.cfg = cfg
        p = cfg
        dm = p.d_model
        self.time_embed = nn.Sequential(GaussianFourierProjection(p.fourier_weights()),
                                        Dense(p.encode_t_dim, p.encode_t_dim))
        if p.embeds:
            self.x_embed = Dense(1, p.dim_embedding)
            self.pos_embed_x = nn.Embedding(p.dims_in, p.dim_embedding)
            self.c_embed = Dense(1, 2 * p.dim_embedding)
            self.pos_embed_c = nn.Embedding(p.dims_c, 2 * p.dim_embedding)
        self.transformer = _Transformer(p)
        self.layers = nn.Sequential(Dense(p.encode_t_dim + dm, p.dim_feedforward),
                                    SiLU(), Dense(p.dim_feedforward, 1))
        set_compute_dtype(self, compute_dtype(p.compute_dtype))

    def _embed_x(self, x, t_feats):
        p = self.cfg
        b, n = x.shape
        if p.embeds:
            idx = torch.arange(n, device=x.device)
            xe = self.x_embed(x[..., None]) + to_dtype(self.pos_embed_x(idx), self.dt)[None]
            return torch.cat([t_feats[:, None, :].expand(b, n, t_feats.shape[1]), xe], dim=-1)
        one_hot = torch.eye(p.dims_in, dtype=x.dtype, device=x.device)[None, :n, :]
        pad = x.new_zeros((b, n, p.dim_embedding - p.dims_in - 1))
        return torch.cat([x[..., None], one_hot.expand(b, n, p.dims_in), pad], dim=-1)

    def _embed_c(self, c):
        p = self.cfg
        b, n = c.shape
        if p.embeds:
            idx = torch.arange(n, device=c.device)
            return self.c_embed(c[..., None]) + to_dtype(self.pos_embed_c(idx), self.dt)[None]
        one_hot = torch.eye(p.dims_c, dtype=c.dtype, device=c.device)[None, :n, :]
        pad = c.new_zeros((b, n, p.dim_embedding - p.dims_c - 1))
        return torch.cat([c[..., None], one_hot.expand(b, n, p.dims_c), pad], dim=-1)

    def condition_memory(self, condition):
        """The encoder's memory of ``condition`` (None without one). A
        sampling ODE evaluates the net at one condition: it makes the memory
        once and hands it to every eval (``memory``)."""
        if condition is None:
            return None
        src = self._embed_c(to_dtype(condition, self.dt))
        for layer in self.transformer.encoder.layers:
            src = layer(src)
        return _norm(self.transformer.encoder.norm, src, self.dt)

    def forward(self, x, t, condition=None, memory=None):
        p = self.cfg
        x = to_dtype(x, self.dt)
        t_feats = self.time_embed(t)
        tgt = self._embed_x(x, t_feats)
        if memory is None:
            memory = x.new_zeros((x.shape[0], x.shape[1], p.d_model)) if condition is None \
                else self.condition_memory(condition)

        # the decoder kernel is valid when the cross-attention memory is one
        # effective token: a 1-token encoder or the all-zero memory
        if p.fused_block is True and (condition is None or p.dims_c == 1):
            return self._fused_decoder(tgt, t_feats, memory)

        h = tgt
        for layer in self.transformer.decoder.layers:
            h = layer(h, memory)
        h = _norm(self.transformer.decoder.norm, h, self.dt)
        head_in = torch.cat([t_feats[:, None, :].expand(-1, h.shape[1], -1), h], dim=-1)
        return f32(self.layers(head_in)[..., 0])

    def kernel_weights(self):
        """The decoder's weights in fused_energy_decoder's layout: per layer
        stacked (L, ...), matrices (in, out), the three LayerNorms (L, 3, D);
        then the final LayerNorm and the head."""
        cols = {k: [] for k in ("ln_s", "ln_b", "wqkv", "bqkv", "wo", "bo",
                                "w1", "b1", "w2", "b2")}
        for layer in self.transformer.decoder.layers:
            sa = layer.self_attn
            norms = (layer.norm1, layer.norm2, layer.norm3)
            for k, w in zip(cols, (torch.stack([n.weight for n in norms]),
                                   torch.stack([n.bias for n in norms]),
                                   sa.in_proj_weight.t(), sa.in_proj_bias,
                                   sa.out_proj.weight.t(), sa.out_proj.bias,
                                   layer.linear1.weight.t(), layer.linear1.bias,
                                   layer.linear2.weight.t(), layer.linear2.bias)):
                cols[k].append(w)
        norm, head0, head1 = self.transformer.decoder.norm, self.layers[0], self.layers[2]
        return (*(torch.stack(v).contiguous() for v in cols.values()), norm.weight, norm.bias,
                head0.weight.t().contiguous(), head0.bias, head1.weight.t().contiguous(),
                head1.bias)

    def _fused_decoder(self, tgt, t_feats, memory):
        """Decoder stack + final LN + head through ops/fused_energy_decoder."""
        p = self.cfg
        dm = p.d_model
        m0 = f32(memory[:, 0, :])
        # cross-attention output per element and layer: out_proj(v_proj(memory)),
        # computed outside the kernel in f32 as the JAX code does
        cross = torch.stack([
            F.linear(F.linear(m0, ca.in_proj_weight[2 * dm:], ca.in_proj_bias[2 * dm:]),
                     ca.out_proj.weight, ca.out_proj.bias)
            for ca in (layer.multihead_attn for layer in self.transformer.decoder.layers)],
            dim=1)
        weights = None if torch.is_grad_enabled() else current_sampling_weights(self)
        if weights is None:  # training: the parameters themselves, autograd follows
            weights = self.kernel_weights()
        return fused_energy_decoder(f32(tgt).contiguous(), f32(t_feats).contiguous(), cross,
                                    *weights, p.nhead, p.activation, p.fused_group)


def ParallelTransformer(param: dict) -> ParallelTransformerNet:
    """Config-surface factory (``_target_: nn.cfm.transformer_cfm.ParallelTransformer``)."""
    return ParallelTransformerNet(EnergyTransformerParams.create(param))
