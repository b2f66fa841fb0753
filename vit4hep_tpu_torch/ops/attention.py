"""Attention, plain PyTorch (port of the plain part of ``vit4hep_tpu/ops/attention.py``).

This is the composed ViT path's attention and the energy transformer's
attention: matmul, softmax in float32, matmul, with no fused library
operator, so that it stays an independent oracle for the hand-written
kernels. The TPU dispatch names (``auto``, ``xla``, ``fused``, ``flash``,
``vmem``) are accepted and all run this plain version: the kernels they pick
on the TPU (``fused_qkv_attention``, ``flash_qkv_attention``,
``flash_attention``, ``vmem_attention``) are still to be ported (ROADMAP.md,
queue 2).
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30
_IMPLS = ("auto", "xla", "fused", "flash", "vmem")


def _check_impl(impl):
    if impl not in _IMPLS:
        raise ValueError(f"Unknown attention impl '{impl}'")


def xla_attention(q, k, v, mask=None, scale=None):
    """softmax(q k^T * scale) v on (B, H, N, D) tensors; mask True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    return torch.matmul(weights, v.float()).to(v.dtype)


def dot_product_attention(q, k, v, mask=None, impl="auto", scale=None):
    """Scaled dot-product attention on (B, H, N, D) tensors."""
    _check_impl(impl)
    return xla_attention(q, k, v, mask, scale=scale)


def qkv_attention(qkv, num_heads, mask=None, impl="auto", scale=None):
    """Attention from the qkv projection's native (B, N, 3*H*D) layout
    (q, k, v blocks of H heads each). Returns the merged (B, N, H*D)
    context."""
    _check_impl(impl)
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    out = xla_attention(q, k, v, mask, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(b, n, num_heads * d)
