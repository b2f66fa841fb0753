"""The DiT megakernel tier: the whole-ViT forward, the per-block forward and
the training kernels (port of ``vit4hep_tpu/ops/fused_dit_block.py``).

Every public function takes the JAX function's arguments, weights in the
Dense layout ``(in, out)``. On CPU tensors it runs its plain PyTorch
version; on CUDA tensors it runs the hand-written kernels of
``csrc/vit_forward.cu``, ``csrc/vit_backward.cu`` and K1's
``csrc/qkv_attention.cu``, or raises. The TPU kernels keep a whole
element's block panel in 128 MiB of VMEM, which a Hopper CTA's 227 KB
cannot hold, so each is split into kernels over all B*N rows, each with
its own wrapper, launch counter and plain version:

- :func:`linear` / :func:`train_linear`: a tiled bf16 tensor-core product
  with a fused epilogue (bias; + positional embedding; tanh-GELU to bf16,
  optionally saving the pre-GELU ``a1``; gated residual ``out = resid +
  gate * (. + b)``, optionally saving ``y = . + b``). :func:`linear` counts
  the sampling forward's launches (K2v, K2b), :func:`train_linear` the
  training forward's and backward's (K5a-c);
- :func:`modln`: LayerNorm (no affine, eps 1e-6) + adaLN modulation to bf16;
- :func:`attention`: softmax(q k^T * scale) v per (batch, head) from the
  native (B, N, 3*H*D) qkv panel, bf16 context, on wgmma
  (``csrc/vit_attention_wgmma.cuh``), counted under :data:`ATTENTION`;
- :func:`gemm_nt`: activation gradients ``dY @ W^T`` (optionally times
  ``gelu'(a1)``, writing bf16 da1 and gelu(a1) beside it);
  :func:`weight_grad`: ``A^T @ dY`` over all rows, split over the rows
  with a deterministic second pass, with the bias gradient as the column
  sums of the f32 dY; both on wgmma with TMA (``csrc/bwd_wgmma.cuh``), on
  bf16 operands that :func:`nt_plan` / :func:`tn_plan` prepare;
  :func:`bwd_rows`: the LayerNorm/adaLN forward and backward rows of the
  block gradient with their per-element reductions (and bf16 copies of dy
  and dattn for the products); :func:`dmod_reduce`: the adaLN gradients
  ``(B, 6, H)`` from those.

The functions of the tier, in JAX's names:

- :func:`fused_vit_forward` (K2v, ``_vit_kernel``): embed + L blocks +
  FinalLayer. Without gradients it is K2v. With gradients it is a
  ``torch.autograd.Function`` whose forward is :func:`vit_fwd_train` (K5a,
  ``_vit_fwd_train``: K2v's forward that also writes the residual set) and
  whose backward is ``_vit_bwd``: plain VJPs of the embedder and the
  FinalLayer, and per block in reverse :func:`fused_dit_block_bwd_res`
  (K5b; ``bwd="pallas"``) or :func:`block_bwd_res_plain` with bf16
  multiplicands (``bwd="xla"``, the hybrid arm: plain PyTorch as it is
  plain XLA in JAX). When no residual tier fits (:func:`_fit_residuals`),
  the forward is K2v and the backward recomputes the block inputs with
  :func:`fused_dit_block` and runs :func:`fused_dit_block_bwd` (K5c).
- :func:`fused_dit_block` (K2b): one block forward (K2v's block body),
  differentiable through :func:`fused_dit_block_bwd` (K5c: the block's
  residuals recomputed with K5a's kernels, then K5b).

Products take bf16 multiplicands and accumulate in f32, as the TPU kernels
do. The attention of the training kernels is K1's f32 forward and backward:
the forward keeps the per-head log-sum-exp ``lse`` (B, heads, N), a
residual the port adds to JAX's set, so that K5b rebuilds the softmax from
it.

The block stack, :func:`fused_dit_stack` (K2s, ``_stack_fwd``), is the L
blocks without the embedder and FinalLayer: K2b's block body L times. With
gradients its forward is :func:`stack_fwd_train` (K5a-stack,
``_stack_fwd_train``: K5a's block kernels) and its backward ``_stack_bwd``
(K5b per block, the plain hybrid arm, or K2b + K5c when no residual tier
fits). No model reaches it, in JAX as here: JAX's tests call it directly.
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops import flash_qkv_attention as ffa
from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa
from vit4hep_tpu_torch.ops.attention import qkv_attention
from vit4hep_tpu_torch.ops.fused_qkv_attention import check_kernel_args, mask_arg

_LN_EPS = 1e-6
EPI_BIAS, EPI_BIAS_POS, EPI_BIAS_GELU, EPI_GATED_RESID = range(4)
_P, _I, _LL, _F = _cuda.P, _cuda.I, _cuda.LL, _cuda.F
_SIGNATURES = {
    "vit_gemm": [_P, _I, _P, _P, _P, _P, _LL, _P, _P, _I, _I, _I, _I, _I, _P],
    "vit_modln": [_P, _P, _P, _LL, _P, _I, _I, _I, _F, _P],
    "vit_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
}
_BWD_SIGNATURES = {
    "vit_gemm_nt": [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    "vit_gemm_tn": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vit_wgrad_reduce": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "vit_bwd_rows": [_I] + [_P] * 14 + [_I] * 5 + [_F, _P],
    "vit_dmod_reduce": [_P, _P, _I, _I, _I, _P],
}

GEMM = _cuda.LaunchCounter("vit_gemm")
MODLN = _cuda.LaunchCounter("vit_modln")
ATTENTION = _cuda.LaunchCounter("vit_attention")
TRAIN_GEMM = _cuda.LaunchCounter("vit_train_gemm")
GEMM_NT = _cuda.LaunchCounter("vit_gemm_nt")
GEMM_TN = _cuda.LaunchCounter("vit_gemm_tn")
WGRAD_REDUCE = _cuda.LaunchCounter("vit_wgrad_reduce")
BWD_ROWS = _cuda.LaunchCounter("vit_bwd_rows")
DMOD_REDUCE = _cuda.LaunchCounter("vit_dmod_reduce")

# weight_grad's tiles (csrc/bwd_wgmma.cuh): 128 x 160 over chunks of whole
# 64-row steps; one persistent CTA on each of an H100's 132 SMs
_TN_ROWS, _TN_COLS, _STEP = 128, 160, 64
_SMS = 132


def _lib():
    return _cuda.load("vit_forward", _SIGNATURES)


def _bwd_lib():
    return _cuda.load("vit_backward", _BWD_SIGNATURES)


def _ln_stats(x):
    """LayerNorm without affine (eps 1e-6): (normalised x, 1 / std)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + _LN_EPS)
    return (x - mu) * inv, inv


def _ln(x):
    return _ln_stats(x)[0]


def _ln_bwd(du, u, inv):
    """VJP of u = (z - mean z) * rsqrt(var z + eps), without affine."""
    return inv * (du - du.mean(-1, keepdim=True) - u * (du * u).mean(-1, keepdim=True))


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gelu_grad(x):
    """d/dx of the tanh GELU."""
    c = math.sqrt(2.0 / math.pi)
    t = torch.tanh(c * (x + 0.044715 * x ** 3))
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3.0 * 0.044715 * x * x)


def _mm(a, w, mm_dtype=torch.float32):
    """a @ w on multiplicands rounded to ``mm_dtype``, accumulated in f32."""
    return a.to(mm_dtype).float() @ w.to(mm_dtype).float()


def _rows_sum(a, b, mm_dtype):
    """a^T @ b over all leading (row) axes: the batched weight gradient."""
    return _mm(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]), mm_dtype)


def _mm_dtype(t):
    """The products' multiplicand type: f32 on the CPU (the TPU kernels'
    interpret mode), bf16 on the card (their compiled precision)."""
    return torch.float32 if t.device.type == "cpu" else torch.bfloat16


# ---------------------------------------------------------------------------
# the residual tier. These are the TPU kernels' VMEM budgets (128 MiB, with
# JAX's margins), kept only so that a configuration takes the same tier in
# both packages; the card's 80 GB holds every tier of the shipped configs
# (a rule for the card's memory may replace them, ROADMAP.md)
# ---------------------------------------------------------------------------
def safe_group(group, n):
    """``_safe_group``: the smallest G' >= group with (G' * n) % 8 == 0."""
    g = max(1, int(group))
    if g > 1 and (g * n) % 8:
        m = 8 // math.gcd(n, 8)
        g = -(-g // m) * m
    return g


def stack_vmem_estimate(n, hdim, fdim, depth, num_heads, group=1):
    """``stack_vmem_estimate``: bytes of the TPU block-stack kernel's VMEM."""
    wbytes = 2 * depth * (hdim * 3 * hdim + hdim * hdim + 2 * hdim * fdim)
    rows = group * n
    panels = 4 * rows * (2 * hdim + 3 * hdim + fdim) * 2
    if hdim // num_heads <= 64:
        scores = 12 * rows * rows * num_heads + 14 * num_heads * rows * hdim
    else:
        scores = 12 * rows * rows
    scores += rows * rows if group > 1 else 0
    return wbytes + panels + scores


def train_residual_bytes(n, hdim, fdim, depth, res_bytes, save_a1=True):
    """``train_residual_bytes``: per-element bytes of the residual set."""
    return ((depth + 1) * n * hdim * 4
            + depth * n * (3 * hdim + hdim + (fdim if save_a1 else 0) + hdim) * res_bytes)


def _fit_residuals(base, n, hdim, fdim, depth, mm_dtype):
    """``_fit_residuals``: (save_a1, rbytes) of the largest residual tier
    whose 1.3x-margined request fits 128 MiB; (False, None) when none does.
    ``mm_dtype`` f32 (the CPU) prices 4-byte residuals, bf16 2-byte ones."""
    rb = 4 if mm_dtype == torch.float32 else 2
    for save_a1 in (True, False):
        rbytes = train_residual_bytes(n, hdim, fdim, depth, rb, save_a1)
        if 1.3 * (base + 2 * rbytes) <= 128 * 1024 * 1024:
            return save_a1, rbytes
    return False, None


def vit_residual_tier(n, pdim, hdim, fdim, out_dim, depth, num_heads, mm_dtype):
    """The tier ``_vit_fwd_train`` takes for the whole ViT."""
    base = (stack_vmem_estimate(n, hdim, fdim, depth, num_heads, 1)
            + 2 * (pdim * hdim + hdim * out_dim) + 4 * n * (hdim + pdim + out_dim))
    return _fit_residuals(base, n, hdim, fdim, depth, mm_dtype)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def dit_block_reference(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
                        mask, num_heads, scale):
    """One adaLN-Zero block, plain f32. x (B, N, H); mod6 (B, 6, H) ordered
    [shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp]."""
    x = x.float()
    mod = mod6.float()
    h = _ln(x) * (1.0 + mod[:, 1:2]) + mod[:, 0:1]
    qkv = h @ wqkv + bqkv
    ctx = qkv_attention(qkv, num_heads, mask, impl="xla", scale=scale)
    x1 = x + mod[:, 2:3] * (ctx @ wout + bout)
    h2 = _ln(x1) * (1.0 + mod[:, 4:5]) + mod[:, 3:4]
    y = _gelu(h2 @ w1 + b1) @ w2 + b2
    return x1 + mod[:, 5:6] * y


def stack_reference(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
    """The L blocks in order (``fused_dit_stack``), plain f32; mods (B, L,
    6, H), weights stacked (L, ...)."""
    for li in range(wqkv.shape[0]):
        x = dit_block_reference(x, mods[:, li], wqkv[li], bqkv[li], wout[li], bout[li], w1[li],
                                b1[li], w2[li], b2[li], mask, num_heads, scale)
    return x


def vit_forward_reference(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv,
                          wout, bout, w1, b1, w2, b2, wfin, bfin, mask,
                          num_heads, scale):
    """The whole-ViT forward, plain f32."""
    x = stack_reference(tokens.float() @ wemb + bemb + pos, mods, wqkv, bqkv, wout, bout, w1, b1,
                        w2, b2, mask, num_heads, scale)
    fm = fmod.float()
    u = _ln(x) * (1.0 + fm[:, 1:2]) + fm[:, 0:1]
    return u @ wfin + bfin


def block_fwd_res_plain(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask,
                        num_heads, scale, mm_dtype=torch.float32, want_lse=False):
    """One block forward with the residual set of ``_block_body(want_res=
    True)``: (out, qkv, ctx, a1, y), f32, the products on ``mm_dtype``
    multiplicands (the attention in f32, as K1 computes it); with
    ``want_lse`` also the attention's log-sum-exp (B, heads, N)."""
    x = x.float()
    mod = mod6.float()
    h = _ln(x) * (1.0 + mod[:, 1:2]) + mod[:, 0:1]
    qkv = _mm(h, wqkv, mm_dtype) + bqkv
    ctx, lse = fqa.attention_fwd_plain(qkv, num_heads, scale, mask)
    x1 = x + mod[:, 2:3] * (_mm(ctx, wout, mm_dtype) + bout)
    h2 = _ln(x1) * (1.0 + mod[:, 4:5]) + mod[:, 3:4]
    a1 = _mm(h2, w1, mm_dtype) + b1
    y = _mm(_gelu(a1), w2, mm_dtype) + b2
    res = (x1 + mod[:, 5:6] * y, qkv, ctx, a1, y)
    return res + (lse,) if want_lse else res


def stack_fwd_train_plain(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads,
                          scale, save_a1=True, mm_dtype=torch.float32):
    """``_stack_fwd_train``'s train kernel, plain: (out, (xs, qkvs, ctxs,
    a1s | None, ys), lses) with xs (B, L+1, N, H) f32 (the block inputs and
    the last block's output), qkvs (B, L, N, 3H), ctxs and ys (B, L, N, H),
    a1s (B, L, N, F), all f32, and lses (B, L, heads, N)."""
    x = x.float()
    xs, res = [x], []
    for li in range(wqkv.shape[0]):
        x, *r = block_fwd_res_plain(x, mods[:, li], wqkv[li], bqkv[li], wout[li], bout[li],
                                    w1[li], b1[li], w2[li], b2[li], mask, num_heads, scale,
                                    mm_dtype, want_lse=True)
        xs.append(x)
        res.append(r)
    qkvs, ctxs, a1s, ys, lses = (torch.stack(t, 1) for t in zip(*res))
    return x, (torch.stack(xs, 1), qkvs, ctxs, a1s if save_a1 else None, ys), lses


def vit_fwd_train_plain(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1,
                        w2, b2, wfin, bfin, mask, num_heads, scale, save_a1=True,
                        mm_dtype=torch.float32):
    """``_vit_fwd_train``'s train kernel, plain: the embedder, then
    :func:`stack_fwd_train_plain`'s blocks and residual set, then the
    FinalLayer: (out, (xs, qkvs, ctxs, a1s | None, ys), lses)."""
    x = _mm(tokens.float(), wemb, mm_dtype) + bemb + pos
    x, saved, lses = stack_fwd_train_plain(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
                                           mask, num_heads, scale, save_a1, mm_dtype)
    fm = fmod.float()
    out = _mm(_ln(x) * (1.0 + fm[:, 1:2]) + fm[:, 0:1], wfin, mm_dtype) + bfin
    return out, saved, lses


def block_bwd_res_plain(xin, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
                        num_heads, scale, mm_dtype=torch.float32, attn_dtype=None):
    """``_block_bwd_res_xla``: the block's gradient from its saved residuals
    (``a1`` may be None: recomputed from h2), every product on ``mm_dtype``
    multiplicands with f32 accumulation, the attention's on ``attn_dtype``
    (default ``mm_dtype``, as JAX; f32 to mirror K1's backward). Returns
    (dx, dmod (B, 6, H), dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2)."""
    hdim = xin.shape[-1]
    d = hdim // num_heads
    scale = d ** -0.5 if scale is None else scale
    mm = lambda a, w: _mm(a, w, mm_dtype)  # noqa: E731
    mma = lambda a, w: _mm(a, w, attn_dtype or mm_dtype)  # noqa: E731
    dw = lambda a, gr: _rows_sum(a, gr, mm_dtype)  # noqa: E731
    x, qkv, ctx, y, g = (t.float() for t in (xin, qkv, ctx, y, g))
    mod = mod6.float()
    m = lambda k: mod[:, k:k + 1]  # noqa: E731

    # ---- cheap re-derivations (no saved-matmul recompute) -----------------
    u, inv1 = _ln_stats(x)
    h = u * (1.0 + m(1)) + m(0)
    attn = mm(ctx, wout) + bout
    x1 = x + m(2) * attn
    u2, inv2 = _ln_stats(x1)
    h2 = u2 * (1.0 + m(4)) + m(3)
    a1 = mm(h2, w1) + b1 if a1 is None else a1.float()
    hid = _gelu(a1)

    # ---- backward ---------------------------------------------------------
    dy = g * m(5)
    dmod5 = (g * y).sum(1)
    dhid = mm(dy, w2.t())
    dw2, db2 = dw(hid, dy), dy.sum((0, 1))
    da1 = dhid * _gelu_grad(a1)
    dh2 = mm(da1, w1.t())
    dw1, db1 = dw(h2, da1), da1.sum((0, 1))
    dmod4, dmod3 = (dh2 * u2).sum(1), dh2.sum(1)
    dx1 = g + _ln_bwd(dh2 * (1.0 + m(4)), u2, inv2)
    dattn = dx1 * m(2)
    dmod2 = (dx1 * attn).sum(1)
    dctx = mm(dattn, wout.t())
    dwout, dbout = dw(ctx, dattn), dattn.sum((0, 1))

    # attention, batched over (B, heads): p re-derived from the saved qkv
    q, k, v = fqa._heads(qkv, num_heads, 3)
    s = mma(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, fqa._NEG_INF))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    lsum = e.sum(-1, keepdim=True)
    p = e / torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
    (gh,) = fqa._heads(dctx, num_heads, 1)
    dv = mma(p.transpose(-1, -2), gh)
    dp = mma(gh, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dqkv = fqa._merge(mma(ds, k), mma(ds.transpose(-1, -2), q), dv)

    dh = mm(dqkv, wqkv.t())
    dwqkv, dbqkv = dw(h, dqkv), dqkv.sum((0, 1))
    dmod1, dmod0 = (dh * u).sum(1), dh.sum(1)
    dx = dx1 + _ln_bwd(dh * (1.0 + m(1)), u, inv1)
    dmod = torch.stack([dmod0, dmod1, dmod2, dmod3, dmod4, dmod5], 1).to(mod6.dtype)
    return (dx, dmod, dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2)


def block_bwd_plain(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, g, mask, num_heads,
                    scale, mm_dtype=torch.float32, attn_dtype=None):
    """``fused_dit_block_bwd``, plain: the block's residuals recomputed,
    then :func:`block_bwd_res_plain`."""
    _, qkv, ctx, a1, y = block_fwd_res_plain(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
                                             mask, num_heads, scale, mm_dtype)
    return block_bwd_res_plain(x, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
                               num_heads, scale, mm_dtype, attn_dtype)


def linear_plain(a, w, bias, epilogue, out=None, pos=None, gate=None, n_tok=1, resid=None,
                 save=None):
    """Plain version of :func:`linear` and :func:`train_linear`: the same
    product in f32 on the same bf16-rounded multiplicands."""
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + bias
    if epilogue == EPI_BIAS:
        return y if out is None else out.copy_(y)
    if epilogue == EPI_BIAS_POS:
        y = y + pos.repeat(a.shape[0] // n_tok, 1)
        return y if out is None else out.copy_(y)
    if save is not None:
        save.copy_(y)
    if epilogue == EPI_BIAS_GELU:
        hid = _gelu(y).to(torch.bfloat16)
        return hid if out is None else out.copy_(hid)
    r = out if resid is None else resid
    return out.copy_(r + gate.repeat_interleave(n_tok, dim=0) * y)


def modln_plain(x, shift, scale, n_tok):
    """Plain version of :func:`modln`."""
    rows = lambda m: m.repeat_interleave(n_tok, dim=0)  # noqa: E731
    return (_ln(x) * (1.0 + rows(scale)) + rows(shift)).to(torch.bfloat16)


def attention_plain(qkv, num_heads, scale, mask=None, mm_dtype=torch.float32):
    """Plain version of :func:`attention`: in f32 (against JAX on the CPU),
    or with ``mm_dtype`` bfloat16 the kernel's own arithmetic (bf16 q, k, v
    and p over 64-key tiles with an online softmax, f32 statistics: K6's
    plain forward, :func:`flash_qkv_attention.flash_fwd_plain`)."""
    if mm_dtype == torch.float32:
        out = qkv_attention(qkv, num_heads, mask, impl="xla", scale=scale)
    else:
        out = ffa.flash_fwd_plain(qkv.float(), num_heads, scale, mask, mm_dtype)[0]
    return out.to(torch.bfloat16)


def gemm_nt_plain(a, w, aux=None, save=None, gelu_save=None):
    """Plain version of :func:`gemm_nt` (``save`` and ``gelu_save``, when
    given, receive bf16(out) and bf16(gelu(aux)))."""
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().t()
    if aux is not None:
        y = y * _gelu_grad(aux.float())
        if gelu_save is not None:
            gelu_save.copy_(_gelu(aux.float()))
    if save is not None:
        save.copy_(y)
    return y


def weight_grad_plain(a, b, gelu=False):
    """Plain version of :func:`weight_grad`."""
    a = _gelu(a.float()) if gelu else a
    return _mm(a.t(), b, torch.bfloat16), b.float().sum(0)


def column_parts(rows, k):
    """The row ranges of one chunk's ``rows`` (a range) whose column sums
    :func:`weight_grad_partial` keeps apart: R = ceil(k / 128) parts (one per
    row tile of its (k, n) output), of ceil(len / R) rows each, the last ones
    short or empty."""
    r = _cdiv(k, _TN_ROWS)
    sub = _cdiv(len(rows), r)
    return [rows[min(i * sub, len(rows)):(i + 1) * sub] for i in range(r)]


def weight_grad_partial_plain(a, b, gelu=False, b16=None):
    """Plain version of :func:`weight_grad_partial` (``b16``, bf16(b), is
    what the products round b to either way)."""
    m, k = a.shape
    s, chunk = _split(m, k, b.shape[1])
    ws, cs = [], []
    for i in range(s):
        rows = range(i * chunk, min(m, (i + 1) * chunk))
        ws.append(weight_grad_plain(a[rows.start:rows.stop], b[rows.start:rows.stop], gelu)[0])
        cs += [b[part.start:part.stop].float().sum(0) for part in column_parts(rows, k)]
    return torch.stack(ws), torch.stack(cs)


def wgrad_reduce_plain(ws, cs):
    """Plain version of :func:`wgrad_reduce`."""
    return ws.sum(0), cs.sum(0)


def bwd_rows_plain(mode, x, mod6, attn=None, g=None, y=None, dgrad=None, dx1=None, copy16=None):
    """Plain version of :func:`bwd_rows`: (its outputs, the (B, 6, H) sums
    over each element's rows in the mode's dmod slots, 0 elsewhere);
    ``copy16``, when given, receives bf16 of mode 1's dy or mode 2's dattn."""
    m = lambda k: mod6[:, k:k + 1]  # noqa: E731
    sums = torch.zeros_like(mod6)
    if mode == 1:
        x1 = x + m(2) * attn
        outs = ((_ln(x) * (1.0 + m(1)) + m(0)).to(torch.bfloat16),
                (_ln(x1) * (1.0 + m(4)) + m(3)).to(torch.bfloat16), g * m(5))
        sums[:, 5] = (g * y.float()).sum(1)
        if copy16 is not None:
            copy16.copy_(outs[2])
        return outs, sums
    z, ks, up = (x + m(2) * attn, 4, g) if mode == 2 else (x, 1, dx1)
    u, inv = _ln_stats(z)
    d = up + _ln_bwd(dgrad * (1.0 + m(ks)), u, inv)
    sums[:, ks] = (dgrad * u).sum(1)
    sums[:, ks - 1] = dgrad.sum(1)
    if mode == 3:
        return (d,), sums
    sums[:, 2] = (d * attn).sum(1)
    if copy16 is not None:
        copy16.copy_(d * m(2))
    return (d, d * m(2)), sums


def dmod_reduce_plain(part):
    """Plain version of :func:`dmod_reduce`."""
    return part.sum(1)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def _rows_view(name, t, rows, width, device=None):
    """Check a (rows, width) float32 view whose rows may be strided (a slice
    of the adaLN panel) but whose columns are contiguous, on ``device`` (by
    default any CUDA device); returns its row stride."""
    on = t.device == device if device is not None else t.device.type == "cuda"
    if not on or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 tensor on {device or 'a CUDA device'}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != (rows, width) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a ({rows}, {width}) view with unit column stride, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def _check_out(name, t, shape, dtype, device=None):
    """Check a contiguous ``dtype`` buffer of ``shape`` on ``device`` (by
    default any CUDA device)."""
    if device is None:
        _cuda.require_cuda(name, t, dtype=dtype)
    elif t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} on {device}, got {t.dtype} on "
                         f"{t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: output has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t


def _aligned(name, what, t, nbytes):
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: {what} is not {nbytes}-byte aligned (TMA needs it)")


def tma_operands(a, w):
    """The GEMM kernel's operands: A in bf16 (an f32 A cast once, rounding to
    nearest even as the plain version's ``.to(torch.bfloat16)`` does) and
    both zero-padded so that every row is a multiple of 16 bytes, as TMA
    needs: A (M, K) and W (K, N) to K8 = K rounded up to 8 (W gains zero
    rows), W to N8 = N rounded up to 8 columns. The product's first N
    columns are unchanged (ds3's 90-wide patches and final layer are the
    shipped operands padded); the kernel stores only those. Returns
    contiguous (a, w); an operand that needs no change is returned as it is."""
    k, n = w.shape
    k8, n8 = _cdiv(k, 8) * 8, _cdiv(n, 8) * 8
    a = a.to(torch.bfloat16)
    if k8 != k:
        a = F.pad(a, (0, k8 - k))
    if (k8, n8) != (k, n):
        w = F.pad(w, (0, n8 - n, 0, k8 - k))
    return a.contiguous(), w.contiguous()


def gemm_plan(name, a, w, bias, epilogue, out, pos, gate, resid, save, n_tok):
    """Check the GEMM's arguments on any device and prepare them: returns
    (a, w) from :func:`tma_operands`, the output, (aux, aux_stride) of the
    epilogue and the residual. Raises ValueError on what the kernel does not
    take: dtypes, shapes that do not chain, rows that are not a multiple of
    n_tok, an epilogue that does not save given ``save``, A or W not 16-byte
    aligned. The kernel itself stores column pairs as vectors where N and
    every epilogue buffer allow it, and one column at a time where not."""
    m, k = a.shape
    n = w.shape[1]
    dev = a.device
    if a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous float32 or bfloat16, got {a.dtype}")
    if w.dtype != torch.bfloat16 or bias.dtype != torch.float32 or not w.is_contiguous() \
            or not bias.is_contiguous() or w.device != dev or bias.device != dev:
        raise ValueError(f"{name}: W must be contiguous bfloat16 and the bias float32 on A's "
                         f"device, got {w.dtype} on {w.device} and {bias.dtype} on {bias.device}")
    if tuple(w.shape) != (k, n) or tuple(bias.shape) != (n,) or m < 1:
        raise ValueError(f"{name}: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not chain")
    if m % n_tok:
        raise ValueError(f"{name}: {m} rows are not a multiple of n_tok {n_tok}")
    new = lambda dt: torch.empty((m, n), dtype=dt, device=dev)  # noqa: E731
    aux, aux_stride = None, 0
    if epilogue == EPI_BIAS_POS:
        if pos is None or pos.dtype != torch.float32 or tuple(pos.shape) != (n_tok, n) \
                or not pos.is_contiguous() or pos.device != dev:
            raise ValueError(f"{name}: pos must be a contiguous float32 {(n_tok, n)}")
        aux = pos
    if epilogue == EPI_GATED_RESID:
        if out is None or gate is None:
            raise ValueError(f"{name}: the gated residual needs its output buffer and gate")
        _check_out(name, out, (m, n), torch.float32, dev)
        resid = out if resid is None else _check_out(name, resid, (m, n), torch.float32, dev)
        aux, aux_stride = gate, _rows_view(f"{name} gate", gate, m // n_tok, n, dev)
    elif epilogue in (EPI_BIAS, EPI_BIAS_POS, EPI_BIAS_GELU):
        dt = torch.bfloat16 if epilogue == EPI_BIAS_GELU else torch.float32
        out = new(dt) if out is None else _check_out(name, out, (m, n), dt, dev)
    else:
        raise ValueError(f"{name}: unknown epilogue {epilogue}")
    if save is not None:
        if epilogue not in (EPI_BIAS_GELU, EPI_GATED_RESID):
            raise ValueError(f"{name}: only the GELU and gated-residual epilogues save")
        _check_out(name, save, (m, n), torch.bfloat16, dev)
    a, w = tma_operands(a, w)
    _aligned(name, "A", a, 16)
    _aligned(name, "W", w, 16)
    return a, w, out, aux, aux_stride, resid


def _gemm(counter, name, a, w, bias, epilogue, out, pos, gate, resid, save, n_tok):
    _cuda.require_cuda(name, a, dtype=a.dtype)
    _cuda.require_cuda(name, w, dtype=w.dtype)
    _cuda.require_cuda(name, bias, dtype=bias.dtype)
    a, w, out, aux, aux_stride, resid = gemm_plan(name, a, w, bias, epilogue, out, pos, gate,
                                                  resid, save, n_tok)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = _lib().vit_gemm(
        a.data_ptr(), 1, w.data_ptr(), bias.data_ptr(), out.data_ptr(), ptr(aux), aux_stride,
        ptr(resid), ptr(save), a.shape[0], bias.shape[0], a.shape[1], n_tok, epilogue,
        _cuda.stream())
    _cuda.check(code, "vit_gemm")
    counter.add()
    return out


def linear(a, w, bias, epilogue, out=None, pos=None, gate=None, n_tok=1, resid=None):
    """``epilogue(a @ w + bias)`` over all rows on the tensor cores, for the
    sampling forward (K2v, K2b).

    a (M, K) float32 or bfloat16; w (K, N) bfloat16; bias (N,) float32.
    EPI_BIAS -> new (M, N) f32; EPI_BIAS_POS -> new f32 plus ``pos``
    (n_tok, N) on row r % n_tok; EPI_BIAS_GELU -> new (M, N) bf16;
    EPI_GATED_RESID -> ``out`` (M, N) f32 = ``resid`` + gate[r // n_tok] *
    (.), with ``gate`` a (M // n_tok, N) view and ``resid`` ``out`` itself
    (in place) unless given. The kernel (``vit_gemm``) reads its operands
    with TMA: an f32 A is cast to bf16 once, and A and W are zero-padded to
    8-column multiples where they are not (ds3's 90-wide patches and final
    layer; :func:`tma_operands`), which leaves the product unchanged. A
    shape or buffer it cannot take raises ValueError (:func:`gemm_plan`).
    Returns the output. Traced, it records ``vit4hep::vit_gemm``, which
    writes a new output (the gated residual reads ``resid``, else
    ``out``)."""
    if _cuda.tracing():
        if epilogue == EPI_GATED_RESID:
            resid = out if resid is None else resid
        elif out is not None:
            raise ValueError("linear: a traced call writes a new output; pass no out")
        return torch.ops.vit4hep.vit_gemm(a, w, bias, epilogue, pos, gate, resid, n_tok)
    return _gemm(GEMM, "linear", a, w, bias, epilogue, out, pos, gate, resid, None, n_tok)


def train_linear(a, w, bias, epilogue, out=None, pos=None, gate=None, n_tok=1, resid=None,
                 save=None):
    """:func:`linear` for the training kernels (K5a-c), counted apart; any
    epilogue may write into a given ``out``, and ``save`` (M, N) bf16
    receives the pre-GELU a1 (EPI_BIAS_GELU) or y = . + bias before the
    gate (EPI_GATED_RESID)."""
    return _gemm(TRAIN_GEMM, "train_linear", a, w, bias, epilogue, out, pos, gate, resid, save,
                 n_tok)


def _modln(counter, x, shift, scale, n_tok):
    m, hdim = x.shape
    _cuda.require_cuda("modln", x)
    if m % n_tok:
        raise ValueError(f"modln: {m} rows are not a multiple of n_tok {n_tok}")
    stride = _rows_view("modln shift", shift, m // n_tok, hdim)
    if _rows_view("modln scale", scale, m // n_tok, hdim) != stride:
        raise ValueError("modln: shift and scale need the same row stride")
    out = torch.empty((m, hdim), dtype=torch.bfloat16, device=x.device)
    code = _lib().vit_modln(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), stride,
                            out.data_ptr(), m, hdim, n_tok, _LN_EPS, _cuda.stream())
    _cuda.check(code, "vit_modln")
    counter.add()
    return out


def modln(x, shift, scale, n_tok):
    """bf16 ``LN(x) * (1 + scale[r // n_tok]) + shift[r // n_tok]``; x (M, H)
    f32, shift/scale (M // n_tok, H) views (rows may be strided, equally).
    Traced, it records ``vit4hep::vit_modln``."""
    if _cuda.tracing():
        return torch.ops.vit4hep.vit_modln(x, shift, scale, n_tok)
    return _modln(MODLN, x, shift, scale, n_tok)


def attention(qkv, num_heads, scale, mask=None):
    """Merged (B, N, H*D) bf16 context from the (B, N, 3*H*D) f32 qkv panel;
    ``mask`` an optional shared (N, N) bool on qkv's device, True = attend.
    The kernel (``vit_attn_wgmma_kernel``, csrc/vit_attention_wgmma.cuh)
    takes bf16 multiplicands with f32 statistics and accumulation, as the
    TPU kernel; its plain version is :func:`attention_plain` with
    ``mm_dtype`` bfloat16. Traced, it records ``vit4hep::vit_attention``."""
    if _cuda.tracing():
        return torch.ops.vit4hep.vit_attention(qkv, num_heads, float(scale), mask)
    _cuda.require_cuda("attention", qkv)
    b, n, d = check_kernel_args("attention", qkv, num_heads)
    mask, mask_ptr = mask_arg("attention", mask, n, qkv.device)
    out = torch.empty((b, n, num_heads * d), dtype=torch.bfloat16, device=qkv.device)
    code = _lib().vit_attention(qkv.data_ptr(), mask_ptr, out.data_ptr(), b, n, num_heads, d,
                                float(scale), _cuda.stream())
    _cuda.check(code, "vit_attention")
    ATTENTION.add()
    return out


def _cdiv(a, b):
    return -(-a // b)


def _pad_cols(t, width):
    return t if t.shape[1] == width else F.pad(t, (0, width - t.shape[1]))


def nt_plan(name, a, w, aux=None, save=None, gelu_save=None):
    """Check gemm_nt's arguments on any device and prepare its TMA operands:
    returns (a, w, aux kind) with A (M, K) in bf16 (an f32 A cast once,
    rounding to nearest even as :func:`gemm_nt_plain` does) and W (N, K)
    bf16, both zero-padded to K8 = K rounded up to 8 columns so that every
    row is a multiple of 16 bytes (the product is unchanged), contiguous;
    the aux kind 0 (none), 1 (bf16 a1) or 2 (f32 a1). Raises ValueError on dtypes, shapes that do not chain,
    side outputs that are not (M, N) bf16 (``gelu_save`` needs ``aux``), or
    operands that are not 16-byte aligned."""
    if a.ndim != 2 or a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(f"{name}: A must be a contiguous float32 or bfloat16 matrix, got "
                         f"{a.dtype} {tuple(a.shape)}")
    m, k = a.shape
    if w.dtype != torch.bfloat16 or w.ndim != 2 or w.shape[1] != k or w.device != a.device:
        raise ValueError(f"{name}: a {tuple(a.shape)} and w {w.dtype} {tuple(w.shape)} on "
                         f"{w.device} do not chain (w must be bfloat16 (N, K) on A's device)")
    n = w.shape[0]
    kind = 0
    if aux is not None:
        if aux.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"{name}: aux must be bfloat16 or float32, got {aux.dtype}")
        _check_out(f"{name} aux", aux, (m, n), aux.dtype, a.device)
        kind = 1 if aux.dtype == torch.bfloat16 else 2
    elif gelu_save is not None:
        raise ValueError(f"{name}: gelu_save needs aux (the pre-GELU a1)")
    for what, t in (("save", save), ("gelu_save", gelu_save)):
        if t is not None:
            _check_out(f"{name} {what}", t, (m, n), torch.bfloat16, a.device)
    k8 = _cdiv(k, 8) * 8
    a, w = (_pad_cols(t.to(torch.bfloat16), k8).contiguous() for t in (a, w))
    _aligned(name, "A", a, 16)
    _aligned(name, "W", w, 16)
    return a, w, kind


def gemm_nt(a, w, aux=None, save=None, gelu_save=None):
    """``a @ w^T`` over all rows: a (M, K) f32 or bf16, w (N, K) bf16 (a
    Dense weight (in = N, out = K)); (M, N) f32, times ``gelu'(aux)`` when
    ``aux`` (the pre-GELU a1 (M, N), bf16 or f32) is given. ``save`` (M, N)
    bf16 receives bf16 of the output and ``gelu_save`` (M, N) bf16
    bf16(gelu(aux)), from the kernel's registers. The kernel reads its
    operands by TMA (:func:`nt_plan`)."""
    _cuda.require_cuda("gemm_nt", a, dtype=a.dtype)
    a16, w16, kind = nt_plan("gemm_nt", a, w, aux, save, gelu_save)
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    code = _bwd_lib().vit_gemm_nt(a16.data_ptr(), w16.data_ptr(), out.data_ptr(), ptr(aux), kind,
                                  ptr(save), ptr(gelu_save), m, n, k, _cuda.stream())
    _cuda.check(code, "vit_gemm_nt")
    GEMM_NT.add()
    return out


def _split(m, k, n):
    """(S, rows per chunk) of weight_grad's split of the m rows: chunks of
    whole 64-row steps, S the number of times the 128 x 160 output tiles of
    (k, n) fit on the 132 SMs (1 to 16)."""
    s = max(1, min(16, _SMS // (_cdiv(k, _TN_ROWS) * _cdiv(n, _TN_COLS))))
    chunk = _cdiv(_cdiv(m, s), _STEP) * _STEP
    return _cdiv(m, chunk), chunk


def tn_plan(name, a, b, b16=None, gelu=False):
    """Check weight_grad's arguments on any device and prepare its TMA
    operands: returns (a, b16, S, chunk) with A (M, K) in bf16 (an f32 A
    cast once) zero-padded to K8 columns and the bf16 copy of b (M, N) (cast
    once unless ``b16`` gives it) zero-padded to N8, both contiguous; S and
    chunk from :func:`_split`. b itself stays f32: its column sums are the
    bias gradient. Raises ValueError on dtypes and shapes, and on ``gelu``:
    the product reads gelu(a1) as the bf16 operand that gemm_nt's
    ``gelu_save`` writes."""
    if gelu:
        raise ValueError(f"{name}: the card's product takes gelu(a1) formed once, as "
                         "gemm_nt's gelu_save writes it: pass that with gelu=False")
    if a.ndim != 2 or a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(f"{name}: a must be a contiguous float32 or bfloat16 matrix, got "
                         f"{a.dtype} {tuple(a.shape)}")
    m, k = a.shape
    if b.ndim != 2 or b.dtype != torch.float32 or not b.is_contiguous() or b.shape[0] != m \
            or b.device != a.device:
        raise ValueError(f"{name}: b must be a contiguous float32 ({m}, N) on a's device, got "
                         f"{b.dtype} {tuple(b.shape)} on {b.device}")
    n = b.shape[1]
    if b16 is None:
        b16 = b.to(torch.bfloat16)
    elif b16.dtype != torch.bfloat16 or tuple(b16.shape) != (m, n) or b16.device != a.device:
        raise ValueError(f"{name}: b16 must be the bfloat16 ({m}, {n}) copy of b, got "
                         f"{b16.dtype} {tuple(b16.shape)}")
    a = _pad_cols(a.to(torch.bfloat16), _cdiv(k, 8) * 8).contiguous()
    b16 = _pad_cols(b16, _cdiv(n, 8) * 8).contiguous()
    _aligned(name, "A", a, 16)
    _aligned(name, "b16", b16, 16)
    return (a, b16, *_split(m, k, n))


def weight_grad_partial(a, b, gelu=False, b16=None):
    """The partial products of :func:`weight_grad`: (ws (S, K, N), cs (S *
    R, N)), ws[s] holding a^T @ b over rows [s * chunk, (s + 1) * chunk)
    (S and chunk from :func:`_split`) and cs the column sums of the f32 b
    over each chunk's R = ceil(K / 128) parts (:func:`column_parts`).
    ``b16`` may give bf16(b), which the product reads (:func:`tn_plan`)."""
    _cuda.require_cuda("weight_grad", a, dtype=a.dtype)
    _cuda.require_cuda("weight_grad", b)
    a16, b16, s, chunk = tn_plan("weight_grad", a, b, b16, gelu)
    m, k = a.shape
    n = b.shape[1]
    ws = torch.empty((s, k, n), dtype=torch.float32, device=a.device)
    cs = torch.empty((s * _cdiv(k, _TN_ROWS), n), dtype=torch.float32, device=a.device)
    code = _bwd_lib().vit_gemm_tn(a16.data_ptr(), b16.data_ptr(), b.data_ptr(), ws.data_ptr(),
                                  cs.data_ptr(), m, k, n, s, chunk, _cuda.stream())
    _cuda.check(code, "vit_gemm_tn")
    GEMM_TN.add()
    return ws, cs


def wgrad_reduce(ws, cs):
    """(ws.sum(0) (K, N), cs.sum(0) (N,)), each summed over its partials in
    order: deterministic, no atomics."""
    _cuda.require_cuda("wgrad_reduce", ws, cs)
    s, k, n = ws.shape
    if cs.ndim != 2 or cs.shape[1] != n:
        raise ValueError(f"wgrad_reduce: ws {tuple(ws.shape)} and cs {tuple(cs.shape)}")
    dw = torch.empty((k, n), dtype=torch.float32, device=ws.device)
    db = torch.empty((n,), dtype=torch.float32, device=ws.device)
    code = _bwd_lib().vit_wgrad_reduce(ws.data_ptr(), cs.data_ptr(), dw.data_ptr(),
                                       db.data_ptr(), s, cs.shape[0], k, n, _cuda.stream())
    _cuda.check(code, "vit_wgrad_reduce")
    WGRAD_REDUCE.add()
    return dw, db


def weight_grad(a, b, gelu=False, b16=None):
    """(a^T @ b (K, N) f32, the column sums of b (N,) f32) over the M rows
    of a (M, K) (f32 or bf16; ``gelu`` raises: dW2 takes gelu(a1) as
    gemm_nt's ``gelu_save`` writes it) and b (M, N) f32: the weight and
    bias gradients of a Dense layer, as
    :func:`weight_grad_partial` over row chunks and :func:`wgrad_reduce` of
    the chunks."""
    return wgrad_reduce(*weight_grad_partial(a, b, gelu, b16))


def row_chunks(n):
    """(S, rows per chunk) of :func:`bwd_rows`: chunks of about 32 rows."""
    s = _cdiv(n, 32)
    return s, _cdiv(n, s)


def bwd_rows(mode, x, mod6, part, attn=None, g=None, y=None, dgrad=None, dx1=None,
             copy16=None):
    """One pass of the block gradient's rows; x and every (B, N, H) input
    f32 contiguous (y bf16), mod6 (B, 6, H) f32 contiguous, ``part`` (B, S,
    6, H) f32 (S from :func:`row_chunks`) receiving the per-chunk sums of
    the mode's adaLN gradients. Mode 1 (attn, g, y): (h, h2) bf16 and dy =
    g * gate_mlp, sums dmod5. Mode 2 (attn, g, dgrad = dh2): dx1, dattn,
    sums dmod2-4. Mode 3 (dgrad = dh, dx1): (dx,), sums dmod0-1. ``copy16``,
    a contiguous (B, N, H) bf16 buffer, receives bf16 of mode 1's dy or
    mode 2's dattn (the copy the products read by TMA)."""
    b, n, hdim = x.shape
    s, rows = row_chunks(n)
    ins = {1: (attn, g, y), 2: (attn, g, dgrad), 3: (dgrad, dx1)}[mode]
    _cuda.require_cuda("bwd_rows", x, mod6, part, *(t for t in ins if t.dtype == torch.float32))
    for t in ins:
        if t.device != x.device or tuple(t.shape) != (b, n, hdim) or not t.is_contiguous():
            raise ValueError(f"bwd_rows: an input of shape {tuple(t.shape)}, expected a "
                             f"contiguous {(b, n, hdim)}")
    if tuple(mod6.shape) != (b, 6, hdim) or tuple(part.shape) != (b, s, 6, hdim):
        raise ValueError(f"bwd_rows: mod6 {tuple(mod6.shape)} / part {tuple(part.shape)} for "
                         f"x {tuple(x.shape)}")
    if mode == 1 and y.dtype != torch.bfloat16:
        raise ValueError("bwd_rows: y must be bfloat16")
    if copy16 is not None:
        if mode == 3:
            raise ValueError("bwd_rows: mode 3 writes no bf16 copy")
        _check_out("bwd_rows copy16", copy16, (b, n, hdim), torch.bfloat16, x.device)
    new = lambda dt: torch.empty((b, n, hdim), dtype=dt, device=x.device)  # noqa: E731
    outs = {1: (new(torch.bfloat16), new(torch.bfloat16), new(torch.float32)),
            2: (new(torch.float32), new(torch.float32)), 3: (new(torch.float32),)}[mode]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    h, h2, dy = outs if mode == 1 else (None, None, None)
    out0 = None if mode == 1 else outs[0]
    code = _bwd_lib().vit_bwd_rows(
        mode, x.data_ptr(), ptr(attn), ptr(g), ptr(y), ptr(dgrad), ptr(dx1), mod6.data_ptr(),
        ptr(h), ptr(h2), ptr(dy), ptr(out0), ptr(outs[1]) if mode == 2 else None, ptr(copy16),
        part.data_ptr(), b, n, hdim, s, rows, _LN_EPS, _cuda.stream())
    _cuda.check(code, "vit_bwd_rows")
    BWD_ROWS.add()
    return outs


def dmod_reduce(part):
    """The adaLN gradients (B, 6, H) f32: the sum over the S chunks of
    ``part`` (B, S, 6, H), in order."""
    _cuda.require_cuda("dmod_reduce", part)
    b, s, six, hdim = part.shape
    if six != 6:
        raise ValueError(f"dmod_reduce: part has shape {tuple(part.shape)}")
    dmod = torch.empty((b, 6, hdim), dtype=torch.float32, device=part.device)
    code = _bwd_lib().vit_dmod_reduce(part.data_ptr(), dmod.data_ptr(), b, s, hdim,
                                      _cuda.stream())
    _cuda.check(code, "vit_dmod_reduce")
    DMOD_REDUCE.add()
    return dmod


# ---------------------------------------------------------------------------
# the tier's functions on the card
# ---------------------------------------------------------------------------
def _bf(w):
    return w.to(torch.bfloat16).contiguous()


def _as(t, dtype):
    """``t`` as a contiguous ``dtype`` tensor; ``t`` itself when it is one
    (a traced forward then records no conversion)."""
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _mmw(w):
    """A weight matrix as the sampling forward's products take it: bf16 on
    the card, f32 on the CPU (a traced forward's CPU ops compute in f32)."""
    return _as(w, _mm_dtype(w))


def _f32(t):
    return _as(t, torch.float32)


_LAYERS: list = []  # [(the stacked weights of the last call, their per-layer slices)]


def _per_layer(ws):
    """Each layer's slices of the stacked block weights ``ws``, made once for
    the weights of the last call: a sampling twin hands the same tensors to
    every net eval, so a traced ODE records the slices once."""
    if not (_LAYERS and len(_LAYERS[0][0]) == len(ws)
            and all(a is b for a, b in zip(_LAYERS[0][0], ws))):
        _LAYERS[:] = [(ws, [tuple(w[li] for w in ws) for li in range(ws[0].shape[0])])]
    return _LAYERS[0][1]


def _block_fwd_kernel(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
    """K2b: one block forward (K2v's block body), bf16 weights; x is left
    unchanged."""
    b, n, hdim = x.shape
    xr = x.reshape(b * n, hdim)
    h = modln(xr, mod6[:, 0], mod6[:, 1], n)
    qkv = linear(h, wqkv, bqkv, EPI_BIAS, n_tok=n)
    ctx = attention(qkv.view(b, n, -1), num_heads, scale, mask)
    out = None if _cuda.tracing() else torch.empty_like(xr)  # a traced GEMM makes its own
    x1 = linear(ctx.view(b * n, hdim), wout, bout, EPI_GATED_RESID, out=out, resid=xr,
                gate=mod6[:, 2], n_tok=n)
    h2 = modln(x1, mod6[:, 3], mod6[:, 4], n)
    hid = linear(h2, w1, b1, EPI_BIAS_GELU, n_tok=n)
    x1 = linear(hid, w2, b2, EPI_GATED_RESID, out=x1, gate=mod6[:, 5], n_tok=n)
    return x1.view(b, n, hdim)


def _block_fwd_res_into(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads,
                        scale, out, qkv, ctx, lse, a1, y):
    """K5a's block: one block forward that writes the block output ``out``
    (B, N, H) f32 and the residuals qkv (B, N, 3H) f32, ctx (B, N, H) f32,
    lse (B, heads, N), a1 (B, N, F) bf16 (unless None) and y (B, N, H) bf16
    into the given buffers; x (B, N, H) f32 is left unchanged (the saved
    block input)."""
    b, n, hdim = x.shape
    m = b * n
    xr = x.view(m, hdim)
    h = modln(xr, mod6[:, 0], mod6[:, 1], n)
    train_linear(h, wqkv, bqkv, EPI_BIAS, out=qkv.view(m, -1), n_tok=n)
    fqa.attention_fwd_kernel(qkv, num_heads, scale, mask, out=ctx, lse=lse)
    x1 = train_linear(ctx.view(m, hdim), wout, bout, EPI_GATED_RESID, out=torch.empty_like(xr),
                      resid=xr, gate=mod6[:, 2], n_tok=n)
    h2 = modln(x1, mod6[:, 3], mod6[:, 4], n)
    hid = train_linear(h2, w1, b1, EPI_BIAS_GELU, n_tok=n,
                       save=None if a1 is None else a1.view(m, -1))
    train_linear(hid, w2, b2, EPI_GATED_RESID, out=out.view(m, hdim), resid=x1, gate=mod6[:, 5],
                 n_tok=n, save=y.view(m, hdim))


def _block_res_buffers(b, n, hdim, fdim, num_heads, device, depth=None, save_a1=True):
    """Empty (out, qkv, ctx, lse, a1, y) of one block, or with ``depth``
    stacked (depth, ...) (out as the (depth + 1, ...) block inputs)."""
    lead = () if depth is None else (depth,)
    new = lambda *shape, dt=torch.float32: torch.empty(  # noqa: E731
        lead + shape, dtype=dt, device=device)
    out = torch.empty(((depth + 1,) if depth is not None else ()) + (b, n, hdim),
                      dtype=torch.float32, device=device)
    return (out, new(b, n, 3 * hdim), new(b, n, hdim), new(b, num_heads, n),
            new(b, n, fdim, dt=torch.bfloat16) if save_a1 else None,
            new(b, n, hdim, dt=torch.bfloat16))


def _block_bwd_res_kernel(xin, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
                          num_heads, scale, lse):
    """K5b on the card: xin, qkv, ctx, g f32 and mod6 f32 contiguous; a1
    bf16/f32 or None; y bf16; weights bf16; lse (B, heads, N) or None. The
    products read bf16 operands by TMA: the row passes write bf16 copies of
    dy and dattn beside them, the GELU-derivative product bf16 da1 and
    gelu(a1), and ctx and K1's dqkv are cast once."""
    b, n, hdim = xin.shape
    m = b * n
    bf = torch.bfloat16
    rows = lambda t: t.reshape(m, -1)  # noqa: E731
    new16 = lambda width: torch.empty((m, width), dtype=bf, device=xin.device)  # noqa: E731
    ctx16 = rows(ctx).to(bf)  # the out-projection's A, then dWout's
    attn = train_linear(ctx16, wout, bout, EPI_BIAS, n_tok=n)
    part = torch.empty((b, row_chunks(n)[0], 6, hdim), dtype=torch.float32, device=xin.device)
    dy16 = new16(hdim)
    h, h2, dy = bwd_rows(1, xin, mod6, part, attn=attn.view(b, n, hdim), g=g, y=y,
                         copy16=dy16.view(b, n, hdim))
    if a1 is None:  # the no-a1 tier: one h2 @ w1 product, f32 as JAX recomputes it
        a1 = train_linear(rows(h2), w1, b1, EPI_BIAS, n_tok=n)
    a1 = rows(a1)
    da1_16, gelu16 = new16(a1.shape[1]), new16(a1.shape[1])
    da1 = gemm_nt(dy16, w2, aux=a1, save=da1_16, gelu_save=gelu16)
    dw2, db2 = weight_grad(gelu16, rows(dy), b16=dy16)
    del gelu16, dy16
    dh2 = gemm_nt(da1_16, w1)
    dw1, db1 = weight_grad(rows(h2), da1, b16=da1_16)
    del da1, da1_16
    dattn16 = new16(hdim)
    dx1, dattn = bwd_rows(2, xin, mod6, part, attn=attn.view(b, n, hdim), g=g,
                          dgrad=dh2.view(b, n, hdim), copy16=dattn16.view(b, n, hdim))
    dctx = gemm_nt(dattn16, wout)
    dwout, dbout = weight_grad(ctx16, rows(dattn), b16=dattn16)
    del dattn16, ctx16
    if lse is None:
        _, lse = fqa.attention_fwd_kernel(qkv, num_heads, scale, mask)
    dqkv = fqa.attention_bwd_kernel(qkv, dctx.view(b, n, hdim), ctx, lse, num_heads, scale, mask)
    dqkv16 = rows(dqkv).to(bf)  # K1's backward writes dqkv in f32, in two passes
    dh = gemm_nt(dqkv16, wqkv)
    dwqkv, dbqkv = weight_grad(rows(h), rows(dqkv), b16=dqkv16)
    (dx,) = bwd_rows(3, xin, mod6, part, dgrad=dh.view(b, n, hdim), dx1=dx1)
    return (dx, dmod_reduce(part), dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2)


# ---------------------------------------------------------------------------
# the tier's public functions (JAX's signatures)
# ---------------------------------------------------------------------------
def _scale(hdim, num_heads, scale):
    return (hdim // num_heads) ** -0.5 if scale is None else float(scale)


def _check_mask(name, mask):
    if mask is not None and mask.ndim != 2:
        raise ValueError(f"{name} supports a shared (N, N) mask")


def _dit_block(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
    """K2b's primal: the plain block on the CPU, the kernels on the card."""
    if x.device.type == "cpu":
        return dit_block_reference(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask,
                                   num_heads, scale)
    x, mod6 = _f32(x), _f32(mod6)
    _cuda.require_cuda("fused_dit_block", x, mod6)
    return _block_fwd_kernel(x, mod6, _bf(wqkv), _f32(bqkv), _bf(wout),
                             _f32(bout), _bf(w1), _f32(b1), _bf(w2), _f32(b2), mask, num_heads,
                             scale)


def fused_dit_block_bwd(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, g, mask, num_heads,
                        scale):
    """K5c: the block's gradient with its forward recomputed. Returns (dx,
    dmod6, dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2), f32. On the
    card the residuals are recomputed with K5a's block kernels, then K5b's
    kernels run on them."""
    _check_mask("fused_dit_block_bwd", mask)
    scale = _scale(x.shape[-1], num_heads, scale)
    if x.device.type == "cpu":
        return block_bwd_plain(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, g, mask,
                               num_heads, scale)
    b, n, hdim = x.shape
    x, mod6, g = _f32(x), _f32(mod6), _f32(g)
    _cuda.require_cuda("fused_dit_block_bwd", x, mod6, g)
    wqkv, wout, w1, w2 = _bf(wqkv), _bf(wout), _bf(w1), _bf(w2)
    bout, b1 = _f32(bout), _f32(b1)
    out, qkv, ctx, lse, a1, y = _block_res_buffers(b, n, hdim, w1.shape[1], num_heads, x.device)
    _block_fwd_res_into(x, mod6, wqkv, _f32(bqkv), wout, bout, w1, b1, w2, _f32(b2), mask,
                        num_heads, scale, out, qkv, ctx, lse, a1, y)
    del out
    return _block_bwd_res_kernel(x, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
                                 num_heads, scale, lse)


def fused_dit_block_bwd_res(xin, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g, mask,
                            num_heads, scale, lse=None):
    """K5b: the gradient of one block from its saved residuals (``a1`` may
    be None: recomputed with one h2 @ w1 product). Returns JAX's (dx,
    dmod6, dwqkv, dbqkv, dwout, dbout, dw1, db1, dw2, db2), f32. On the
    card the attention backward is K1's on the f32 qkv panel, from the
    forward's ``lse`` (B, heads, N) when given, else from K1's forward
    recomputed here; y goes to the kernels in bf16, the type it is saved
    in."""
    _check_mask("fused_dit_block_bwd_res", mask)
    scale = _scale(xin.shape[-1], num_heads, scale)
    if xin.device.type == "cpu":
        return block_bwd_res_plain(xin, qkv, ctx, a1, y, mod6, wqkv, wout, bout, w1, b1, w2, g,
                                   mask, num_heads, scale)
    xin, qkv, ctx, mod6, g = (_f32(t) for t in (xin, qkv, ctx, mod6, g))
    _cuda.require_cuda("fused_dit_block_bwd_res", xin, qkv, ctx, mod6, g)
    if a1 is not None:
        a1 = a1.contiguous() if a1.dtype == torch.bfloat16 else _f32(a1)
    if lse is not None:
        lse = _f32(lse)
    return _block_bwd_res_kernel(xin, qkv, ctx, a1, _bf(y), mod6, _bf(wqkv), _bf(wout),
                                 _f32(bout), _bf(w1), _f32(b1), _bf(w2), g, mask, num_heads,
                                 scale, lse)


class _FusedDiTBlock(torch.autograd.Function):
    """K2b forward, K5c backward (``_block_fwd`` / ``_block_bwd``)."""

    @staticmethod
    def forward(ctx, x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
        ctx.save_for_backward(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2)
        ctx.mask, ctx.num_heads, ctx.scale = mask, num_heads, scale
        return _dit_block(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads,
                          scale)

    @staticmethod
    def backward(ctx, g):
        grads = fused_dit_block_bwd(*ctx.saved_tensors, g, ctx.mask, ctx.num_heads, ctx.scale)
        return grads + (None, None, None)


def fused_dit_block(x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
    """K2b: one adaLN-Zero block, x (B, N, H), mod6 (B, 6, H); differentiable
    (backward K5c) when gradients are enabled and an input requires them."""
    _check_mask("fused_dit_block", mask)
    scale = _scale(x.shape[-1], num_heads, scale)
    args = (x, mod6, wqkv, bqkv, wout, bout, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedDiTBlock.apply(*args, mask, num_heads, scale)
    return _dit_block(*args, mask, num_heads, scale)


def _blocks_res_into(xs, qkvs, ctxs, lses, a1s, ys, mods, wqkv, bqkv, wout, bout, w1, b1, w2,
                     b2, mask, num_heads, scale):
    """K5a's block loop: block li reads xs[li] and writes xs[li + 1] and its
    residuals into the (L, ...) buffers of :func:`_block_res_buffers`;
    weights already cast (bf16 matrices, f32 biases)."""
    for li in range(wqkv.shape[0]):
        _block_fwd_res_into(xs[li], mods[:, li], wqkv[li], bqkv[li], wout[li], bout[li], w1[li],
                            b1[li], w2[li], b2[li], mask, num_heads, scale, xs[li + 1],
                            qkvs[li], ctxs[li], lses[li], None if a1s is None else a1s[li],
                            ys[li])


def _batch_major(xs, qkvs, ctxs, lses, a1s, ys):
    """The residual set as JAX orders it, (B, L, ...) views of the (L, B,
    ...) buffers: ((xs, qkvs, ctxs, a1s | None, ys), lses)."""
    t = lambda r: None if r is None else r.transpose(0, 1)  # noqa: E731
    return (t(xs), t(qkvs), t(ctxs), t(a1s), t(ys)), t(lses)


def _cast_weights(wqkv, bqkv, wout, bout, w1, b1, w2, b2):
    """The block weights as the kernels take them: bf16 matrices, f32 biases."""
    return (_bf(wqkv), _f32(bqkv), _bf(wout), _f32(bout), _bf(w1), _f32(b1), _bf(w2), _f32(b2))


def vit_fwd_train(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
                  wfin, bfin, mask, num_heads, scale, save_a1=True):
    """K5a: the whole-ViT forward that also writes the residual set: (out,
    (xs, qkvs, ctxs, a1s | None, ys), lses), shaped as in
    :func:`vit_fwd_train_plain`. On the card xs, qkvs and ctxs are f32, a1s
    and ys bf16 (the TPU kernel's residual types; the attention's qkv and
    context stay f32 for K1's backward), each a (B, L, ...) view of a
    (L, B, ...) buffer, so that one block's slice is contiguous."""
    _check_mask("vit_fwd_train", mask)
    scale = _scale(wemb.shape[1], num_heads, scale)
    if tokens.device.type == "cpu":
        return vit_fwd_train_plain(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout,
                                   w1, b1, w2, b2, wfin, bfin, mask, num_heads, scale, save_a1)
    b, n, pdim = tokens.shape
    depth, hdim, fdim = wqkv.shape[0], wemb.shape[1], w1.shape[-1]
    m = b * n
    tokens, pos, mods, fmod = (_f32(t) for t in (tokens, pos, mods, fmod))
    _cuda.require_cuda("vit_fwd_train", tokens, pos, mods, fmod)
    bufs = _block_res_buffers(b, n, hdim, fdim, num_heads, tokens.device, depth, save_a1)
    xs = bufs[0]
    train_linear(tokens.view(m, pdim), _bf(wemb), _f32(bemb), EPI_BIAS_POS,
                 out=xs[0].view(m, hdim), pos=pos, n_tok=n)
    _blocks_res_into(*bufs, mods, *_cast_weights(wqkv, bqkv, wout, bout, w1, b1, w2, b2), mask,
                     num_heads, scale)
    h = modln(xs[depth].view(m, hdim), fmod[:, 0], fmod[:, 1], n)
    out = train_linear(h, _bf(wfin), _f32(bfin), EPI_BIAS, n_tok=n).view(b, n, -1)
    return (out, *_batch_major(*bufs))


def _stack_forward(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale):
    """K2s: the L blocks in order, no residuals: the plain f32 blocks on the
    CPU, K2b's block body (``vit_gemm``, ``vit_modln``, ``vit_attention``)
    per block on the card. Traced, it is K2b's block body on any device, each
    launch a registered op."""
    traced = _cuda.tracing()
    if x.device.type == "cpu" and not traced:
        return stack_reference(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads,
                               scale)
    x, mods = _f32(x), _f32(mods)
    if not traced:
        _cuda.require_cuda("fused_dit_stack", x, mods)
    ws = (_mmw(wqkv), _f32(bqkv), _mmw(wout), _f32(bout), _mmw(w1), _f32(b1), _mmw(w2),
          _f32(b2))
    for li, layer in enumerate(_per_layer(ws)):
        x = _block_fwd_kernel(x, mods[:, li], *layer, mask, num_heads, scale)
    return x


def _vit_forward(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
                 wfin, bfin, mask, num_heads, scale):
    """K2v: the sampling forward (the plain version on the CPU). Traced, it
    is the card's sequence of launches on any device, each a registered op
    (``vit4hep::vit_gemm``, ``vit_modln``, ``vit_attention``), whose CPU
    implementations compute in f32 what :func:`vit_forward_reference`
    does, in the same order."""
    traced = _cuda.tracing()
    if tokens.device.type == "cpu" and not traced:
        return vit_forward_reference(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv,
                                     wout, bout, w1, b1, w2, b2, wfin, bfin, mask,
                                     num_heads, scale)
    b, n, pdim = tokens.shape
    if not traced:
        _cuda.require_cuda("fused_vit_forward", tokens, pos, mods, fmod)
    x = linear(tokens.reshape(b * n, pdim), _mmw(wemb), bemb.contiguous(), EPI_BIAS_POS,
               pos=pos, n_tok=n).view(b, n, -1)
    x = _stack_forward(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale)
    h = modln(x.view(b * n, -1), fmod[:, 0], fmod[:, 1], n)
    out = linear(h, _mmw(wfin), bfin.contiguous(), EPI_BIAS, n_tok=n)
    return out.reshape(b, n, -1)


def _final(x, fmod, wfin, bfin):
    fm = fmod.float()
    return (_ln(x) * (1.0 + fm[:, 1:2]) + fm[:, 0:1]) @ wfin + bfin


def _blocks_bwd(dx, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale, bwd,
                inputs=None, res=None):
    """``_blocks_bwd``: the blocks' gradients in reverse from dx, the
    gradient of the last block's output. From the saved residual set
    ``res`` ((xs, qkvs, ctxs, a1s | None, ys), lses): K5b per block, or with
    ``bwd="xla"`` the plain residual backward on the products' multiplicand
    type (the hybrid arm); else from the block inputs ``inputs`` (a list,
    recomputed by the caller): K5c per block. Returns (dx, dmods (B, L, 6,
    H), the 8 weight and bias gradients stacked (L, ...))."""
    depth = wqkv.shape[0]
    if dx.is_cuda:  # one cast of the weights for every block's kernels
        wqkv_m, wout_m, w1_m, w2_m = _bf(wqkv), _bf(wout), _bf(w1), _bf(w2)
    else:
        wqkv_m, wout_m, w1_m, w2_m = wqkv, wout, w1, w2
    dmods, dws = [None] * depth, [[None] * depth for _ in range(8)]
    for li in reversed(range(depth)):
        if res is None:
            grads = fused_dit_block_bwd(inputs[li], mods[:, li], wqkv[li], bqkv[li], wout[li],
                                        bout[li], w1[li], b1[li], w2[li], b2[li], dx, mask,
                                        num_heads, scale)
        else:
            (xs, qkvs, ctxs, a1s, ys), lses = res
            args = (xs[:, li], qkvs[:, li], ctxs[:, li], None if a1s is None else a1s[:, li],
                    ys[:, li], mods[:, li])
            if bwd == "xla":
                grads = block_bwd_res_plain(*args, wqkv[li], wout[li], bout[li], w1[li], b1[li],
                                            w2[li], dx, mask, num_heads, scale, _mm_dtype(dx))
            else:
                grads = fused_dit_block_bwd_res(*args, wqkv_m[li], wout_m[li], bout[li],
                                                w1_m[li], b1[li], w2_m[li], dx, mask, num_heads,
                                                scale, lse=lses[:, li])
        dx, dmods[li] = grads[0], grads[1]
        for wi in range(8):
            dws[wi][li] = grads[2 + wi]
    return dx, torch.stack(dmods, 1), [torch.stack(d) for d in dws]


class _FusedViT(torch.autograd.Function):
    """``fused_vit_forward``'s custom VJP: ``_vit_fwd_train`` / ``_vit_bwd``."""

    @staticmethod
    def forward(ctx, tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2,
                b2, wfin, bfin, mask, num_heads, scale, bwd):
        ins = (tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2, b2,
               wfin, bfin)
        b, n, pdim = tokens.shape
        depth, hdim, fdim = wqkv.shape[0], wemb.shape[1], w1.shape[-1]
        save_a1, rbytes = vit_residual_tier(n, pdim, hdim, fdim, wfin.shape[1], depth,
                                            num_heads, _mm_dtype(tokens))
        if rbytes is None:  # no tier fits: the backward recomputes (K2b + K5c)
            if bwd == "xla":  # shown once: the default warnings filter
                warnings.warn("fused_vit_forward: no residual tier fits, so bwd='xla' (the "
                              "hybrid arm) does not apply: the backward recomputes the blocks "
                              "and runs K5c", stacklevel=2)
            out, ctx.res = _vit_forward(*ins, mask, num_heads, scale), None
        else:
            out, saved, lses = vit_fwd_train(*ins, mask, num_heads, scale, save_a1)
            ctx.res = (saved, lses)
        ctx.save_for_backward(*ins)
        ctx.mask, ctx.num_heads, ctx.scale, ctx.bwd = mask, num_heads, scale, bwd
        return out

    @staticmethod
    def backward(ctx, g):
        (tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2, b2, wfin,
         bfin) = ctx.saved_tensors
        res, ctx.res = ctx.res, None  # the residuals go with this backward
        mask, heads, scale = ctx.mask, ctx.num_heads, ctx.scale
        depth = wqkv.shape[0]
        g = g.contiguous()
        xs = None
        if res is None:
            xs = [tokens.float() @ wemb + bemb + pos]
            for li in range(depth):
                xs.append(_dit_block(xs[-1], mods[:, li], wqkv[li], bqkv[li], wout[li],
                                     bout[li], w1[li], b1[li], w2[li], b2[li], mask, heads,
                                     scale))
            x_last = xs[depth]
        else:
            x_last = res[0][0][:, depth]
        with torch.enable_grad():
            fin = [t.detach().requires_grad_() for t in (x_last, fmod, wfin, bfin)]
            dx, dfmod, dwfin, dbfin = torch.autograd.grad(_final(*fin), fin, g)
        dx, dmods, dws = _blocks_bwd(dx, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask,
                                     heads, scale, ctx.bwd, xs, res)
        rows = dx.reshape(-1, dx.shape[-1])
        dtokens = dx @ wemb.t()
        dwemb = tokens.reshape(-1, tokens.shape[-1]).float().t() @ rows
        return (dtokens, dx.sum(0), dmods, dfmod, dwemb, rows.sum(0), *dws, dwfin, dbfin, None,
                None, None, None)


def fused_vit_forward(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout,
                      bout, w1, b1, w2, b2, wfin, bfin, mask, num_heads,
                      scale, group=1, bwd="pallas"):
    """Whole-ViT forward. tokens (B, N, P); pos (N, H); mods (B, L, 6, H);
    fmod (B, 2, H) [shift, scale]; wemb (P, H); block weights stacked (L,
    ...); wfin (H, OUT). Returns (B, N, OUT) f32.

    ``mask`` is an optional shared (N, N) bool, True = attend (the
    layer-causal ViT; ``_vit_kernel_masked``). ``group`` is the TPU's batch
    elements per grid cell (``_vit_kernel_g``, which keeps the G elements
    apart with a block-diagonal mask): it is accepted and ignored, since
    every kernel here already spans all B*N rows and attends within each
    element, which is the grouped kernel's function for any G. With
    gradients enabled and an input requiring them, the forward saves the
    residual set (K5a) and ``bwd`` picks the block backward: "pallas" (K5b)
    or "xla" (the plain hybrid arm)."""
    del group
    _check_mask("fused_vit_forward", mask)
    if bwd not in ("pallas", "xla"):
        raise ValueError(f"fused_vit_forward: bwd must be 'pallas' or 'xla', got {bwd!r}")
    scale = _scale(wemb.shape[1], num_heads, scale)
    args = (tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout, bout, w1, b1, w2, b2, wfin,
            bfin)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedViT.apply(*args, mask, num_heads, scale, bwd)
    return _vit_forward(*args, mask, num_heads, scale)


# ---------------------------------------------------------------------------
# the block stack (K2s, K5a-stack); ViTNet takes fused_vit_forward first, under
# the same conditions, in both packages
# ---------------------------------------------------------------------------
def stack_residual_tier(n, hdim, fdim, depth, num_heads, mm_dtype):
    """The tier ``_stack_fwd_train`` takes for the block stack: (save_a1,
    rbytes), rbytes None when no residual set fits."""
    return _fit_residuals(stack_vmem_estimate(n, hdim, fdim, depth, num_heads, 1), n, hdim,
                          fdim, depth, mm_dtype)


def stack_fwd_train(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale,
                    save_a1=True):
    """K5a-stack (``_stack_fwd_train``'s train kernel): the L blocks, writing
    the residual set: (out, (xs, qkvs, ctxs, a1s | None, ys), lses), shaped
    as in :func:`stack_fwd_train_plain` and typed as in :func:`vit_fwd_train`,
    whose block kernels it runs without the embedder and FinalLayer."""
    _check_mask("fused_dit_stack", mask)
    scale = _scale(x.shape[-1], num_heads, scale)
    if x.device.type == "cpu":
        return stack_fwd_train_plain(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask,
                                     num_heads, scale, save_a1)
    b, n, hdim = x.shape
    x, mods = _f32(x), _f32(mods)
    _cuda.require_cuda("fused_dit_stack", x, mods)
    bufs = _block_res_buffers(b, n, hdim, w1.shape[-1], num_heads, x.device, wqkv.shape[0],
                              save_a1)
    bufs[0][0].copy_(x)
    _blocks_res_into(*bufs, mods, *_cast_weights(wqkv, bqkv, wout, bout, w1, b1, w2, b2), mask,
                     num_heads, scale)
    return (bufs[0][-1].clone(), *_batch_major(*bufs))


class _FusedDiTStack(torch.autograd.Function):
    """``fused_dit_stack``'s custom VJP: ``_stack_fwd_train`` / ``_stack_bwd``."""

    @staticmethod
    def forward(ctx, x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale,
                bwd):
        ins = (x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2)
        save_a1, rbytes = stack_residual_tier(x.shape[1], x.shape[2], w1.shape[-1],
                                              wqkv.shape[0], num_heads, _mm_dtype(x))
        if rbytes is None:  # no tier fits: K2s, and the backward recomputes (K2b + K5c)
            out, ctx.res = _stack_forward(*ins, mask, num_heads, scale), None
        else:
            out, saved, lses = stack_fwd_train(*ins, mask, num_heads, scale, save_a1)
            ctx.res = (saved, lses)
        ctx.save_for_backward(*ins)
        ctx.mask, ctx.num_heads, ctx.scale, ctx.bwd = mask, num_heads, scale, bwd
        return out

    @staticmethod
    def backward(ctx, g):
        x, mods, *ws = ctx.saved_tensors
        res, ctx.res = ctx.res, None  # the residuals go with this backward
        inputs = None
        if res is None:  # the block inputs again, with K2b (L - 1 forwards)
            inputs = [x.float()]
            for li in range(ws[0].shape[0] - 1):
                inputs.append(_dit_block(inputs[-1], mods[:, li], *(w[li] for w in ws),
                                         ctx.mask, ctx.num_heads, ctx.scale))
        dx, dmods, dws = _blocks_bwd(g.contiguous(), mods, *ws, ctx.mask, ctx.num_heads,
                                     ctx.scale, ctx.bwd, inputs, res)
        return (dx, dmods, *dws, None, None, None, None)


def fused_dit_stack(x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2, mask, num_heads, scale,
                    group=1, bwd="pallas"):
    """The L DiT blocks, no embedder and no FinalLayer. x (B, N, H); mods
    (B, L, 6, H); weights stacked (L, ...); ``mask`` an optional shared (N,
    N) bool, True = attend. Returns (B, N, H) f32.

    Without gradients it is K2s (``_stack_fwd``): K2b's block body L times.
    ``group`` is the TPU's batch elements per grid cell (``_stack_kernel_g``,
    whose zero-padded batch is sliced back): accepted and ignored, since
    every kernel here spans all B*N rows and attends within each element,
    the grouped kernel's function for any G. With gradients enabled and an
    input requiring them, the forward is K5a-stack when a residual tier
    fits (:func:`stack_residual_tier`), and the backward runs per block in
    reverse K5b (``bwd="pallas"``) or the plain hybrid arm (``bwd="xla"``);
    when none fits, the forward is K2s and the backward recomputes the
    block inputs with K2b and runs K5c."""
    del group
    _check_mask("fused_dit_stack", mask)
    if bwd not in ("pallas", "xla"):
        raise ValueError(f"fused_dit_stack: bwd must be 'pallas' or 'xla', got {bwd!r}")
    scale = _scale(x.shape[-1], num_heads, scale)
    args = (x, mods, wqkv, bqkv, wout, bout, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedDiTStack.apply(*args, mask, num_heads, scale, bwd)
    return _stack_forward(*args, mask, num_heads, scale)


# ---------------------------------------------------------------------------
# the sampling forward's launches as registered ops (what a traced K2v
# records): the kernel, counted, on CUDA tensors; on CPU tensors the plain
# product in the weights' type (f32 in a CPU trace, whose weights are f32)
# ---------------------------------------------------------------------------
@torch.library.custom_op(
    "vit4hep::vit_gemm", mutates_args=(),
    schema="(Tensor a, Tensor w, Tensor bias, int epilogue, Tensor? pos, Tensor? gate, "
           "Tensor? resid, int n_tok) -> Tensor")
def vit_gemm_op(a, w, bias, epilogue, pos, gate, resid, n_tok):
    """:func:`linear` into a new output; the gated residual adds to
    ``resid``."""
    if a.device.type == "cpu":
        y = a.to(w.dtype).float() @ w.float() + bias
        if epilogue == EPI_BIAS_POS:
            return y + pos.repeat(a.shape[0] // n_tok, 1)
        if epilogue == EPI_BIAS_GELU:
            return _gelu(y).to(w.dtype)
        if epilogue == EPI_GATED_RESID:
            return resid + gate.repeat_interleave(n_tok, dim=0) * y
        return y
    out = torch.empty(resid.shape, dtype=torch.float32, device=a.device) \
        if epilogue == EPI_GATED_RESID else None
    return _gemm(GEMM, "linear", a, w, bias, epilogue, out, pos, gate, resid, None, n_tok)


@vit_gemm_op.register_fake
def _(a, w, bias, epilogue, pos, gate, resid, n_tok):
    dt = w.dtype if epilogue == EPI_BIAS_GELU else torch.float32
    return a.new_empty((a.shape[0], w.shape[1]), dtype=dt)


@torch.library.custom_op("vit4hep::vit_modln", mutates_args=(),
                         schema="(Tensor x, Tensor shift, Tensor scale, int n_tok) -> Tensor")
def vit_modln_op(x, shift, scale, n_tok):
    """:func:`modln`; in f32 on CPU tensors."""
    if x.device.type == "cpu":
        rows = lambda m: m.repeat_interleave(n_tok, dim=0)  # noqa: E731
        return _ln(x) * (1.0 + rows(scale)) + rows(shift)
    return _modln(MODLN, x, shift, scale, n_tok)


@vit_modln_op.register_fake
def _(x, shift, scale, n_tok):
    return x.new_empty(x.shape, dtype=_mm_dtype(x))


@torch.library.custom_op(
    "vit4hep::vit_attention", mutates_args=(),
    schema="(Tensor qkv, int num_heads, float scale, Tensor? mask) -> Tensor")
def vit_attention_op(qkv, num_heads, scale, mask):
    """:func:`attention`; the plain f32 attention on CPU tensors."""
    if qkv.device.type == "cpu":
        return qkv_attention(qkv, num_heads, mask, impl="xla", scale=scale)
    return attention(qkv, num_heads, scale, mask)


@vit_attention_op.register_fake
def _(qkv, num_heads, scale, mask):
    b, n, width = qkv.shape
    return qkv.new_empty((b, n, width // 3), dtype=_mm_dtype(qkv))
