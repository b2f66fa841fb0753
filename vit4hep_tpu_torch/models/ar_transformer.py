"""The legacy autoregressive energy network (port of
``vit4hep_tpu/models/ar_transformer.py``, the reference's
``nn/cfm/transformer.py`` ``ARtransformer``).

A causal encoder-decoder transformer over the u-vector's components with
one 1-D CFM subnet shared by every dimension. Training evaluates all
dimensions at once (teacher-forced, the decoder's self-attention causal);
sampling generates one dimension after another, each a 1-D flow-matching
ODE (``ops/ode.odeint``) conditioned on the decoder's embedding of the
prefix. The encoder and decoder layers are the energy transformer's
(``models/energy_transformer.py``), the time encoding its frozen Gaussian
Fourier projection with the JAX package's deterministic weights. No shipped
config names the model; the remap table takes the reference's and the JAX
package's targets (``utils/config.TARGET_REMAP``), and
``utils/jax_params.convert_ar_transformer_params`` carries JAX's
parameters over.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit4hep_tpu_torch.models.cfm import draw
from vit4hep_tpu_torch.models.energy_transformer import DecoderLayer, EncoderLayer
from vit4hep_tpu_torch.ops.ode import NET_EVALS_PER_STEP, grid_steps, odeint, parse_odeint_kwargs
from vit4hep_tpu_torch.ops.pos_embed import gaussian_fourier_projection
from vit4hep_tpu_torch.utils.misc import without_grad

_LN_EPS = 1e-5
_ACT = {"SiLU": nn.SiLU, "ReLU": nn.ReLU, "GELU": lambda: nn.GELU(approximate="tanh")}


@dataclasses.dataclass(frozen=True)
class ARTransformerParams:
    """Field names and defaults are the JAX class's."""

    shape: tuple = (45,)
    n_con: int = 1
    dim_embedding: int = 64
    n_head: int = 4
    n_encoder_layers: int = 2
    n_decoder_layers: int = 2
    dim_feedforward: int = 256
    dropout_transformer: float = 0.0
    x_embed: bool = False
    c_embed: bool = False
    layer_cond: bool = False
    encode_t_dim: int = 64
    encode_t_scale: float = 30.0
    intermediate_dim: int = 512
    layers_per_block: int = 8
    activation: str = "SiLU"

    @classmethod
    def create(cls, param: dict) -> "ARTransformerParams":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in dict(param).items() if k in known}
        if "shape" in kwargs:
            kwargs["shape"] = tuple(kwargs["shape"])
        return cls(**kwargs)

    @property
    def dims_in(self) -> int:
        return int(self.shape[0])


def _sincos_positional(n, d):
    pos = np.arange(n)[:, None]
    div = np.exp(np.arange(0, d, 2) * (-np.log(10000.0) / d))
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class ARTransformerNet(nn.Module):
    """``forward(c, x_t, t, x)`` -> the velocity of every dimension; the
    prefix embedding (:meth:`embedding_for`) and the 1-D velocity
    (:meth:`velocity_1d`) share its weights for sampling."""

    def __init__(self, cfg: ARTransformerParams):
        super().__init__()
        self.cfg = p = cfg
        d = p.dim_embedding
        w = np.random.default_rng(20260816).normal(size=(p.encode_t_dim // 2,)) \
            * p.encode_t_scale
        self.register_buffer("t_freqs", torch.as_tensor(w, dtype=torch.float32),
                             persistent=False)
        self.time_embed = nn.Linear(p.encode_t_dim, p.encode_t_dim)
        self.encoders = nn.ModuleList(
            EncoderLayer(d, p.n_head, p.dim_feedforward, "relu", "xla")
            for _ in range(p.n_encoder_layers))
        self.decoders = nn.ModuleList(
            DecoderLayer(d, p.n_head, p.dim_feedforward, "relu", "xla")
            for _ in range(p.n_decoder_layers))
        self.encoder_norm = nn.LayerNorm(d, eps=_LN_EPS)
        self.decoder_norm = nn.LayerNorm(d, eps=_LN_EPS)
        if p.x_embed:
            self.x_embed = nn.ModuleList([nn.Linear(1, d), nn.Linear(d, d)])
        if p.c_embed:
            self.c_embed = nn.ModuleList([nn.Linear(1, d), nn.Linear(d, d)])
        n_in = 1 + p.encode_t_dim + d + (p.dims_in if p.layer_cond else 0)
        layers = [nn.Linear(n_in, p.intermediate_dim), _ACT[p.activation]()]
        for _ in range(1, p.layers_per_block - 1):
            layers += [nn.Linear(p.intermediate_dim, p.intermediate_dim), _ACT[p.activation]()]
        self.subnet = nn.Sequential(*layers, nn.Linear(p.intermediate_dim, 1))
        self.register_buffer("positions", torch.from_numpy(
            _sincos_positional(max(p.dims_in, p.n_con) + 1, d)), persistent=False)

    def _t_feats(self, t):
        return self.time_embed(gaussian_fourier_projection(t.reshape(-1, 1).float(),
                                                           self.t_freqs))

    def _embed(self, x, dim, embed_net, act=None):
        """One-hot of the position and zero padding, or the learned
        embedding (Linear, ``act``, Linear) plus sin-cos positions."""
        b, n, f = x.shape
        if embed_net is None:
            one_hot = torch.eye(dim, dtype=x.dtype, device=x.device)[None, :n, :].expand(b, n, dim)
            pad = x.new_zeros((b, n, self.cfg.dim_embedding - dim - f))
            return torch.cat([x, one_hot, pad], dim=-1)
        h = embed_net[0](x)
        if act is not None:
            h = act(h)
        return embed_net[1](h) + self.positions[None, :n]

    def _embed_c(self, c):
        return self._embed(c, self.cfg.n_con, self.c_embed if self.cfg.c_embed else None,
                           act=F.relu)

    def _embed_x(self, x):
        return self._embed(x, self.cfg.dims_in + 1, self.x_embed if self.cfg.x_embed else None)

    def _transform(self, src, tgt):
        n = tgt.shape[1]
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool, device=tgt.device))
        for enc in self.encoders:
            src = enc(src)
        src = self.encoder_norm(src)
        h = tgt
        for dec in self.decoders:
            h = dec(h, src, causal)
        return self.decoder_norm(h)

    def _one_hot(self, b, rows, dtype, device):
        """The dimensions' one-hots appended to the embedding (``layer_cond``)."""
        return torch.eye(self.cfg.dims_in, dtype=dtype, device=device)[rows][None].expand(
            b, len(rows), self.cfg.dims_in)

    def _velocity(self, x_t, t_feats, embedding):
        return self.subnet(torch.cat([x_t, t_feats, embedding], dim=-1))

    def forward(self, c, x_t, t, x):
        """The teacher-forced pass. c (B, n_con, 1); x_t, t, x (B, dims_in, 1):
        the noisy components, their times and the clean targets."""
        xp = F.pad(x[:, :-1], (0, 0, 1, 0))
        embedding = self._transform(self._embed_c(c), self._embed_x(xp))
        if self.cfg.layer_cond:
            embedding = torch.cat([embedding, self._one_hot(
                len(c), range(self.cfg.dims_in), embedding.dtype, embedding.device)], dim=-1)
        t_feats = self._t_feats(t.reshape(-1)).reshape(t.shape[0], t.shape[1], -1)
        return self._velocity(x_t, t_feats, embedding)

    def embedding_for(self, c, x_prefix):
        """The decoder's embedding of the next dimension after ``x_prefix``
        (B, n, 1)."""
        return self._transform(self._embed_c(c), self._embed_x(x_prefix))[:, -1:]

    def velocity_1d(self, x_t, t, embedding):
        """The 1-D velocity of one dimension: x_t (B, 1), t (B, 1)."""
        t_feats = self._t_feats(t.reshape(-1)).reshape(x_t.shape[0], 1, -1)
        return self._velocity(x_t[:, None], t_feats, embedding)[:, 0]


class ARtransformerModel(nn.Module):
    """The generative model over :class:`ARTransformerNet` with the CFM
    surface (``batch_loss``, ``sample_batch``): the draws come from an
    explicit ``torch.Generator`` or are handed in."""

    model_type = "cfm"

    def __init__(self, param: dict, odeint_kwargs=None, **_ignored):
        super().__init__()
        self.cfg = ARTransformerParams.create(param)
        self.net = ARTransformerNet(self.cfg)
        self.shape = (self.cfg.dims_in,)
        self.ode_kwargs = parse_odeint_kwargs(odeint_kwargs or dict(param).get("solver_kwargs"))

    @property
    def condition_dim(self) -> int:
        return self.cfg.n_con

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def x_shape(self, batch_size: int) -> tuple:
        return (batch_size, *self.shape)

    def batch_loss(self, x, c, generator=None, t=None, x_0=None, rows=None):
        """The teacher-forced CFM loss over every dimension: t ~ U(0, 1) of
        shape (B, dims_in, 1) and x_0 ~ N(0, 1) of x's shape (B, dims_in, 1)
        are drawn from ``generator`` unless given (``rows`` as in
        ``CFM.batch_loss``)."""
        c = c[..., None] if c.ndim == 2 else c
        x = x[..., None] if x.ndim == 2 else x
        if t is None:
            t = draw(torch.rand, (x.shape[0], x.shape[1], 1), generator, x, rows)
        if x_0 is None:
            x_0 = draw(torch.randn, x.shape, generator, x, rows)
        x_t = (1 - t) * x_0 + t * x
        v = self.net(c, x_t, t, x)
        return torch.mean((v - (x - x_0)) ** 2)

    @without_grad
    def sample_batch(self, c, generator=None, noise=None):
        """Dimension after dimension: each re-encodes the prefix and solves a
        1-D ODE from its x_0 ~ N(0, 1), column i of ``noise`` (B, dims_in)
        when given, else drawn from ``generator`` in turn."""
        c = c[..., None] if c.ndim == 2 else c
        b, d = c.shape[0], self.cfg.dims_in
        if noise is not None and tuple(noise.shape) != (b, d):
            raise ValueError(f"noise has shape {tuple(noise.shape)}, expected {(b, d)}")
        x = c.new_zeros((b, 1, 1))
        for i in range(d):
            emb = self.net.embedding_for(c, x)
            if self.cfg.layer_cond:
                emb = torch.cat([emb, self.net._one_hot(b, [i], emb.dtype, emb.device)], dim=-1)
            x_0 = torch.randn((b, 1), generator=generator, device=c.device, dtype=c.dtype) \
                if noise is None else noise[:, i:i + 1]

            def f(t, x_t, emb=emb):
                return self.net.velocity_1d(x_t, torch.full((b, 1), t, dtype=x_t.dtype,
                                                            device=x_t.device), emb)

            x_new = odeint(f, x_0, t0=0.0, t1=1.0, **self.ode_kwargs)
            x = torch.cat([x, x_new[:, :, None]], dim=1)
        return x[:, 1:, 0]

    def net_evals_per_sample(self) -> int:
        method = self.ode_kwargs.get("method", "rk4")
        return self.cfg.dims_in * NET_EVALS_PER_STEP[method] * grid_steps(
            self.ode_kwargs.get("step_size", 0.05))

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())


def ARtransformer(param: dict, **kwargs) -> ARtransformerModel:
    """Config-surface factory (``_target_: nn.cfm.transformer.ARtransformer``)."""
    return ARtransformerModel(param, **kwargs)
