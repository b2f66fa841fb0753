"""Whole-ViT sampler forward: patch embedding + positional add, L adaLN-Zero
DiT blocks, FinalLayer (port of ``fused_vit_forward`` in
``vit4hep_tpu/ops/fused_dit_block.py``: ``_vit_kernel``, its masked twin
``_vit_kernel_masked`` and its grouped twin ``_vit_kernel_g``).

:func:`fused_vit_forward` takes the JAX function's arguments, weights in the
Dense layout ``(in, out)``. On CPU tensors it runs
:func:`vit_forward_reference`, the plain PyTorch version. On CUDA tensors it
runs the hand-written kernels of ``csrc/vit_forward.cu`` or raises. The TPU
kernel keeps a whole element's 6-block panel in 128 MiB of VMEM, which a
Hopper CTA's 227 KB cannot hold, so the same computation is split into three
kernels, each with its own wrapper, launch counter and plain version:

- :func:`linear`: a tiled bf16 tensor-core product over all B*N rows with a
  fused epilogue (bias; + positional embedding; tanh-GELU to bf16; gated
  residual ``x += gate * (. + b)`` in place);
- :func:`modln`: LayerNorm (no affine, eps 1e-6) + adaLN modulation to bf16;
- :func:`attention`: softmax(q k^T * scale) v per (batch, head), read from
  the native (B, N, 3*H*D) qkv panel, merged (B, N, H*D) bf16 context; K
  and V stream through shared memory in 64-row tiles (any N), with the
  optional shared (N, N) mask (the layer-causal ViT). It is K1's forward
  kernel (``csrc/attention_fwd.cuh``) writing bf16, counted here under
  its own :data:`ATTENTION` counter.

Products take bf16 multiplicands and accumulate in f32, as the TPU kernel
does. The block stack ``fused_dit_stack``, the per-block ``fused_dit_block``
and the training kernels are still to be ported (ROADMAP.md, queue 2).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.attention import qkv_attention
from vit4hep_tpu_torch.ops.fused_qkv_attention import check_kernel_args, mask_arg

_LN_EPS = 1e-6
EPI_BIAS, EPI_BIAS_POS, EPI_BIAS_GELU, EPI_GATED_RESID = range(4)
_P, _I, _LL, _F = _cuda.P, _cuda.I, _cuda.LL, _cuda.F
_SIGNATURES = {
    "vit_gemm": [_P, _I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    "vit_modln": [_P, _P, _P, _LL, _P, _I, _I, _I, _F, _P],
    "vit_attention": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
}

GEMM = _cuda.LaunchCounter("vit_gemm")
MODLN = _cuda.LaunchCounter("vit_modln")
ATTENTION = _cuda.LaunchCounter("vit_attention")


def _lib():
    return _cuda.load("vit_forward", _SIGNATURES)


def _ln(x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


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


def vit_forward_reference(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv,
                          wout, bout, w1, b1, w2, b2, wfin, bfin, mask,
                          num_heads, scale):
    """The whole-ViT forward, plain f32."""
    x = tokens.float() @ wemb + bemb + pos
    for li in range(wqkv.shape[0]):
        x = dit_block_reference(
            x, mods[:, li], wqkv[li], bqkv[li], wout[li], bout[li],
            w1[li], b1[li], w2[li], b2[li], mask, num_heads, scale,
        )
    fm = fmod.float()
    u = _ln(x) * (1.0 + fm[:, 1:2]) + fm[:, 0:1]
    return u @ wfin + bfin


def linear_plain(a, w, bias, epilogue, out=None, pos=None, gate=None, n_tok=1):
    """Plain version of :func:`linear`: the same product in f32 on the same
    bf16-rounded multiplicands."""
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + bias
    if epilogue == EPI_BIAS:
        return y
    if epilogue == EPI_BIAS_POS:
        return y + pos.repeat(a.shape[0] // n_tok, 1)
    if epilogue == EPI_BIAS_GELU:
        return _gelu(y).to(torch.bfloat16)
    out += gate.repeat_interleave(n_tok, dim=0) * y
    return out


def modln_plain(x, shift, scale, n_tok):
    """Plain version of :func:`modln`."""
    rows = lambda m: m.repeat_interleave(n_tok, dim=0)  # noqa: E731
    return (_ln(x) * (1.0 + rows(scale)) + rows(shift)).to(torch.bfloat16)


def attention_plain(qkv, num_heads, scale, mask=None):
    """Plain version of :func:`attention`."""
    return qkv_attention(qkv, num_heads, mask, impl="xla", scale=scale).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def _rows_view(name, t, rows, width):
    """Check a (rows, width) view whose rows may be strided (a slice of the
    adaLN panel) but whose columns are contiguous; returns its row stride."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
    if tuple(t.shape) != (rows, width) or t.stride(1) != 1:
        raise ValueError(f"{name}: expected a ({rows}, {width}) view with unit column stride, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def linear(a, w, bias, epilogue, out=None, pos=None, gate=None, n_tok=1):
    """``epilogue(a @ w + bias)`` over all rows on the tensor cores.

    a (M, K) float32 or bfloat16; w (K, N) bfloat16; bias (N,) float32.
    EPI_BIAS -> new (M, N) f32; EPI_BIAS_POS -> new f32 plus ``pos``
    (n_tok, N) on row r % n_tok; EPI_BIAS_GELU -> new (M, N) bf16;
    EPI_GATED_RESID -> ``out`` (M, N) f32 += gate[r // n_tok] * (.), in
    place, with ``gate`` a (M // n_tok, N) view."""
    m, k = a.shape
    n = w.shape[1]
    if a.dtype not in (torch.float32, torch.bfloat16) or not a.is_contiguous():
        raise ValueError(f"linear: A must be contiguous float32 or bfloat16, got {a.dtype}")
    _cuda.require_cuda("linear", a, dtype=a.dtype)
    _cuda.require_cuda("linear", w, dtype=torch.bfloat16)
    _cuda.require_cuda("linear", bias)
    if tuple(w.shape) != (k, n) or tuple(bias.shape) != (n,):
        raise ValueError(f"linear: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"bias {tuple(bias.shape)} do not chain")
    if m % n_tok:
        raise ValueError(f"linear: {m} rows are not a multiple of n_tok {n_tok}")
    aux, aux_stride = None, 0
    if epilogue == EPI_BIAS_POS:
        _cuda.require_cuda("linear", pos)
        if tuple(pos.shape) != (n_tok, n):
            raise ValueError(f"linear: pos has shape {tuple(pos.shape)}, expected {(n_tok, n)}")
        aux = pos
    if epilogue == EPI_GATED_RESID:
        _cuda.require_cuda("linear", out)
        if tuple(out.shape) != (m, n):
            raise ValueError(f"linear: residual has shape {tuple(out.shape)}, expected {(m, n)}")
        aux, aux_stride = gate, _rows_view("linear gate", gate, m // n_tok, n)
    elif epilogue == EPI_BIAS_GELU:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    elif epilogue in (EPI_BIAS, EPI_BIAS_POS):
        out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    else:
        raise ValueError(f"linear: unknown epilogue {epilogue}")
    code = _lib().vit_gemm(
        a.data_ptr(), int(a.dtype == torch.bfloat16), w.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if aux is None else aux.data_ptr(), aux_stride,
        m, n, k, n_tok, epilogue, _cuda.stream())
    _cuda.check(code, "vit_gemm")
    GEMM.add()
    return out


def modln(x, shift, scale, n_tok):
    """bf16 ``LN(x) * (1 + scale[r // n_tok]) + shift[r // n_tok]``; x (M, H)
    f32, shift/scale (M // n_tok, H) views (rows may be strided, equally)."""
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
    MODLN.add()
    return out


def attention(qkv, num_heads, scale, mask=None):
    """Merged (B, N, H*D) bf16 context from the (B, N, 3*H*D) f32 qkv panel;
    ``mask`` an optional shared (N, N) bool on qkv's device, True = attend."""
    _cuda.require_cuda("attention", qkv)
    b, n, d = check_kernel_args("attention", qkv, num_heads)
    mask, mask_ptr = mask_arg("attention", mask, n, qkv.device)
    out = torch.empty((b, n, num_heads * d), dtype=torch.bfloat16, device=qkv.device)
    code = _lib().vit_attention(qkv.data_ptr(), mask_ptr, out.data_ptr(), b, n, num_heads, d,
                                float(scale), _cuda.stream())
    _cuda.check(code, "vit_attention")
    ATTENTION.add()
    return out


def fused_vit_forward(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv, wout,
                      bout, w1, b1, w2, b2, wfin, bfin, mask, num_heads,
                      scale, group=1):
    """Whole-ViT sampler forward. tokens (B, N, P); pos (N, H); mods
    (B, L, 6, H); fmod (B, 2, H) [shift, scale]; wemb (P, H); block weights
    stacked (L, ...); wfin (H, OUT). Returns (B, N, OUT) f32.

    ``mask`` is an optional shared (N, N) bool, True = attend (the
    layer-causal ViT; ``_vit_kernel_masked``). ``group`` is the TPU's batch
    elements per grid cell (``_vit_kernel_g``, which keeps the G elements
    apart with a block-diagonal mask): it is accepted and ignored, since
    every kernel here already spans all B*N rows and attends within each
    element, which is the grouped kernel's function for any G."""
    del group
    if mask is not None and mask.ndim != 2:
        raise ValueError("fused_vit_forward supports a shared (N, N) mask")
    d = wemb.shape[1] // num_heads
    scale = d ** -0.5 if scale is None else scale
    if tokens.device.type == "cpu":
        return vit_forward_reference(tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv,
                                     wout, bout, w1, b1, w2, b2, wfin, bfin, mask,
                                     num_heads, scale)
    b, n, pdim = tokens.shape
    depth = wqkv.shape[0]
    bf = lambda w: w.to(torch.bfloat16).contiguous()  # noqa: E731
    _cuda.require_cuda("fused_vit_forward", tokens, pos, mods, fmod)
    x = linear(tokens.reshape(b * n, pdim), bf(wemb), bemb.contiguous(), EPI_BIAS_POS,
               pos=pos, n_tok=n)
    wqkv, wout, w1, w2 = bf(wqkv), bf(wout), bf(w1), bf(w2)
    for li in range(depth):
        h = modln(x, mods[:, li, 0], mods[:, li, 1], n)
        qkv = linear(h, wqkv[li], bqkv[li].contiguous(), EPI_BIAS, n_tok=n)
        ctx = attention(qkv.reshape(b, n, -1), num_heads, scale, mask)
        linear(ctx.reshape(b * n, -1), wout[li], bout[li].contiguous(), EPI_GATED_RESID,
               out=x, gate=mods[:, li, 2], n_tok=n)
        h = modln(x, mods[:, li, 3], mods[:, li, 4], n)
        hid = linear(h, w1[li], b1[li].contiguous(), EPI_BIAS_GELU, n_tok=n)
        linear(hid, w2[li], b2[li].contiguous(), EPI_GATED_RESID, out=x,
               gate=mods[:, li, 5], n_tok=n)
    h = modln(x, fmod[:, 0], fmod[:, 1], n)
    out = linear(h, bf(wfin), bfin.contiguous(), EPI_BIAS, n_tok=n)
    return out.reshape(b, n, -1)
