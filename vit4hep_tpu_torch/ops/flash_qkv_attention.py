"""Online-softmax attention straight off the qkv panel, forward and backward
(port of ``vit4hep_tpu/ops/flash_qkv_attention.py``, kernel K6).

:func:`flash_qkv_attention` takes the JAX function's arguments: the
``(B, N, 3*H*D)`` qkv panel (last axis ordered [q/k/v, head, dim]), the head
count, an optional shared ``(N, N)`` boolean mask (True = attend), the logit
scale and the TPU kernel's block sizes. It returns the merged ``(B, N, H*D)``
context and is a ``torch.autograd.Function``: the forward keeps the
per-head log-sum-exp ``(B, N, H)``, the backward takes delta = rowsum(dO *
O) per head and emits the merged ``(B, N, 3*H*D)`` cotangent, as the TPU
kernels do. :func:`flash_qkv_fits` is the TPU kernel's panel-residency bound,
kept bit for bit, because the dispatch (``ops/attention.py``) routes by it.

Products take ``mm_dtype`` multiplicands with f32 accumulation (the TPU
kernel's ``mm_dtype``, ``flash_qkv_attention.py:225``): f32 in the plain
versions on the CPU, bf16 on the card. On CPU tensors the wrapper runs
:func:`flash_fwd_plain` over key blocks of the TPU kernel's ``block_k`` and
:func:`flash_bwd_plain`; on CUDA tensors it launches the kernels of
``csrc/flash_qkv_attention.cu`` (key tiles of :data:`TILE`) or raises: the
forward, then K1's delta kernel and the dQ and dK/dV kernels, each with its
own launch counter (the delta under K1's). The pad guard of the TPU kernel
holds in both: keys past N weigh exactly 0, so a fully masked row gets the
mean of V over the N real keys, and its backward weighs every key 0 (JAX's
``where(valid, exp(s - lse), 0)``).
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops import fused_qkv_attention as fqa

_NEG_INF = -1e30
TILE = 64  # the kernels' key (and query) tile
_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_SIGNATURES = {
    "flash_qkv_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "flash_qkv_bwd_dq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "flash_qkv_bwd_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

FWD = _cuda.LaunchCounter("flash_qkv_fwd")
BWD_DQ = _cuda.LaunchCounter("flash_qkv_bwd_dq")
BWD_DKV = _cuda.LaunchCounter("flash_qkv_bwd_dkv")


def _lib():
    return _cuda.load("flash_qkv_attention", _SIGNATURES)


def _round_up(n, m):
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# the TPU kernel's bound, as JAX computes it
# ---------------------------------------------------------------------------
def _vmem_request(n_pad, hd, block_q, block_k, mm_dtype, extra=0):
    panel = n_pad * 3 * hd * (4 if mm_dtype == torch.float32 else 2)
    blocks = 4 * block_q * (2 * hd + 3 * hd) * 4 + 16 * block_q * block_k
    return int(1.35 * (panel + blocks + extra))


def flash_qkv_fits(n, hd, block_q=512, block_k=512, num_heads=0) -> bool:
    """The TPU kernel's panel-residency bound (``flash_qkv_fits``,
    ``vit4hep_tpu/ops/flash_qkv_attention.py:253``): the whole (N_pad, 3HD)
    bf16 panel and the backward's extra residency in 128 MiB of VMEM. Kept
    so that both packages route a length alike; past it JAX takes the
    separated-layout flash kernel K7."""
    bq = min(block_q, _round_up(n, 128))
    bk = min(block_k, _round_up(n, 128))
    n_pad = _round_up(n, max(bq, bk))
    return _vmem_request(n_pad, hd, bq, bk, torch.bfloat16,
                         extra=2 * n_pad * (hd + num_heads) * 4) <= 128 * 1024 * 1024


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def _mm(a, b, mm_dtype):
    return torch.matmul(a.to(mm_dtype).float(), b.to(mm_dtype).float())


def flash_fwd_plain(qkv, num_heads, scale, mask=None, mm_dtype=torch.float32, block_k=TILE):
    """``_fwd_kernel``: (context (B, N, H*D) in qkv's dtype, lse (B, N, H)
    f32), an online softmax over key blocks of ``block_k``: per block the
    running max, p = exp(s - max) rounded to ``mm_dtype`` for the P . V
    product, and the rescale of the sums by exp(max_old - max_new). Masked
    scores are -1e30; keys past N (the TPU kernel's padding) add nothing."""
    q, k, v = fqa._heads(qkv.float(), num_heads, 3)
    n = q.shape[-2]
    m = torch.full(q.shape[:-1] + (1,), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    acc = torch.zeros_like(q)
    for k0 in range(0, n, block_k):
        sl = slice(k0, k0 + block_k)
        s = _mm(q, k[..., sl, :].transpose(-1, -2), mm_dtype) * scale
        if mask is not None:
            s = torch.where(mask[:, sl], s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)  # noqa: E741
        acc = acc * alpha + _mm(p, v[..., sl, :], mm_dtype)
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = fqa._merge(acc / l_safe)
    return out.to(qkv.dtype), (m + torch.log(l_safe))[..., 0].transpose(1, 2).contiguous()


def flash_bwd_plain(qkv, g, out, lse, num_heads, scale, mask=None, mm_dtype=torch.float32):
    """``_flash_qkv_bwd``: dqkv (B, N, 3*H*D) from the panel, the context's
    gradient g, the context and the lse (B, N, H): delta = rowsum(g * out)
    per head, p = exp(s - lse) on the mask and 0 off it, dV = p^T g, dp =
    g V^T, ds = p (dp - delta) * scale, dQ = ds K, dK = ds^T Q."""
    q, k, v = fqa._heads(qkv.float(), num_heads, 3)
    (gh,) = fqa._heads(g.float(), num_heads, 1)
    delta = fqa.delta_plain(g, out, num_heads)[..., None]
    s = _mm(q, k.transpose(-1, -2), mm_dtype) * scale
    p = torch.exp(s - lse.transpose(1, 2)[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    dv = _mm(p.transpose(-1, -2), gh, mm_dtype)
    ds = p * (_mm(gh, v.transpose(-1, -2), mm_dtype) - delta) * scale
    return fqa._merge(_mm(ds, k, mm_dtype), _mm(ds.transpose(-1, -2), q, mm_dtype),
                      dv).to(qkv.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def flash_fwd_kernel(qkv, num_heads, scale, mask=None):
    """Launch the forward kernel: (context (B, N, H*D) f32, lse (B, N, H) f32)."""
    _cuda.require_cuda("flash_qkv_fwd", qkv)
    b, n, d = fqa.check_kernel_args("flash_qkv_fwd", qkv, num_heads)
    mask, mask_ptr = fqa.mask_arg("flash_qkv_fwd", mask, n, qkv.device)
    out = torch.empty((b, n, num_heads * d), dtype=torch.float32, device=qkv.device)
    lse = torch.empty((b, n, num_heads), dtype=torch.float32, device=qkv.device)
    code = _lib().flash_qkv_fwd(qkv.data_ptr(), mask_ptr, out.data_ptr(), lse.data_ptr(), b,
                                num_heads, n, d, float(scale), _cuda.stream())
    _cuda.check(code, "flash_qkv_fwd")
    FWD.add()
    return out, lse


def _bwd(name, counter, qkv, g, lse, delta, num_heads, scale, dqkv, mask):
    _cuda.require_cuda(name, qkv, g, lse, delta, dqkv)
    b, n, d = fqa.check_kernel_args(name, qkv, num_heads)
    if tuple(g.shape) != (b, n, num_heads * d) or tuple(lse.shape) != (b, n, num_heads) \
            or tuple(delta.shape) != (b, num_heads, n) or dqkv.shape != qkv.shape:
        raise ValueError(f"{name}: g {tuple(g.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)} or dqkv {tuple(dqkv.shape)} do not match qkv "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    mask, mask_ptr = fqa.mask_arg(name, mask, n, qkv.device)
    code = getattr(_lib(), name)(qkv.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                 mask_ptr, dqkv.data_ptr(), b, num_heads, n, d, float(scale),
                                 _cuda.stream())
    _cuda.check(code, name)
    counter.add()
    return dqkv


def flash_bwd_dq_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the dQ kernel: writes the q columns of ``dqkv``; delta (B, H,
    N) is K1's delta pass."""
    return _bwd("flash_qkv_bwd_dq", BWD_DQ, qkv, g, lse, delta, num_heads, scale, dqkv, mask)


def flash_bwd_dkv_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the dK/dV kernel: writes the k and v columns of ``dqkv``."""
    return _bwd("flash_qkv_bwd_dkv", BWD_DKV, qkv, g, lse, delta, num_heads, scale, dqkv, mask)


def flash_bwd_kernel(qkv, g, out, lse, num_heads, scale, mask=None):
    """dqkv through K1's delta kernel and the dQ and dK/dV kernels."""
    delta = fqa.attention_bwd_delta_kernel(g, out, num_heads)
    dqkv = torch.empty_like(qkv)
    flash_bwd_dkv_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)
    return flash_bwd_dq_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)


class _FlashQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale, mask, block_k):
        if qkv.device.type == "cpu":
            out, lse = flash_fwd_plain(qkv, num_heads, scale, mask, block_k=block_k)
        else:
            out, lse = flash_fwd_kernel(qkv, num_heads, scale, mask)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale, ctx.mask = num_heads, scale, mask
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        g = g.contiguous()
        if qkv.device.type == "cpu":
            dqkv = flash_bwd_plain(qkv, g, out, lse, ctx.num_heads, ctx.scale, ctx.mask)
        else:
            dqkv = flash_bwd_kernel(qkv, g, out, lse, ctx.num_heads, ctx.scale, ctx.mask)
        return dqkv, None, None, None, None


def flash_qkv_attention(qkv, num_heads, mask=None, scale=None, block_q=512, block_k=512):
    """Merged (B, N, H*D) context from the native (B, N, 3*H*D) qkv panel,
    differentiable. ``mask``: optional shared (N, N) bool on qkv's device,
    True = attend; ``scale`` overrides 1/sqrt(D); ``block_q``/``block_k``
    are the TPU kernel's blocks: the plain version's key blocks follow
    ``block_k`` as JAX's do (the query blocks do not change its function),
    and the kernels stream :data:`TILE`-row tiles whatever they say. A bf16
    panel runs the f32 arm on its values and the context is rounded to bf16,
    as JAX's kernel stores it: that arm already multiplies in bf16 on the
    card."""
    if qkv.dtype == torch.bfloat16:
        return flash_qkv_attention(qkv.float(), num_heads, mask, scale, block_q,
                                   block_k).to(torch.bfloat16)
    _, n, d = fqa._dims(qkv, num_heads)
    if mask is not None:
        if mask.ndim != 2:
            raise ValueError("flash_qkv_attention supports a shared (N, N) mask")
        fqa.mask_arg("flash_qkv_attention", mask, n, qkv.device)
    scale = d ** -0.5 if scale is None else float(scale)
    return _FlashQKVAttention.apply(qkv.contiguous(), num_heads, scale, mask,
                                    min(block_k, _round_up(n, 128)))
