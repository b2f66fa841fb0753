"""Attention dispatch (port of ``vit4hep_tpu/ops/attention.py``).

``xla`` is the plain version everywhere: matmul, softmax in float32, matmul,
with no fused library operator, so that it stays an independent oracle for
the hand-written kernels (the energy transformer's default). On bf16 inputs
(``compute_dtype: bfloat16``) it keeps JAX's ``xla_attention``: f32 logits,
the weights rounded to bf16 for the f32-accumulated P . V, the output in
bf16; the kernels take a bf16 panel as their modules say.

:func:`qkv_attention` keeps the JAX dispatch on the native (B, N, 3*H*D)
layout: ``auto`` picks ``fused`` (``ops/fused_qkv_attention``, kernel K1,
forward and backward) from 128 tokens while the TPU kernel's working-set
bound ``fused_fits`` holds, ``flash`` past it, and the plain version below
128; an explicit ``fused`` beyond the bound raises ``ValueError`` as in
JAX. A shared 2-D (N, N) mask keeps ``auto`` on the kernels
(``vit4hep_tpu/ops/attention.py:140-150``); a batched mask goes to the plain
version. ``flash`` runs ``ops/flash_qkv_attention`` (kernel K6) on the panel
while ``flash_qkv_fits`` holds; ``vmem``, ``xla``, and ``flash`` past that
bound split the panel into (B, H, N, D) views for
:func:`dot_product_attention`, whose ``auto`` picks ``vmem`` at 288-1024
tokens and ``flash`` above. There ``vmem`` runs
``ops/vmem_attention`` (kernel K8) within the TPU kernel's bound (an explicit
``vmem`` beyond it raises ``ValueError``, as in JAX), and ``flash`` runs
``ops/flash_attention`` (kernel K7, the streaming separated-layout kernel,
forward and backward, at any N). Both kernels attend a sequence to itself:
q and k of different lengths (cross-attention) raise ``ValueError`` for
``flash`` and ``vmem``, where JAX's reshape fails. Every kernel wrapper runs
its plain version on a CPU tensor and its kernel, or raises, on any other.
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops.flash_attention import flash_attention
from vit4hep_tpu_torch.ops.flash_qkv_attention import flash_qkv_attention, flash_qkv_fits
from vit4hep_tpu_torch.ops.fused_qkv_attention import fused_qkv_attention
from vit4hep_tpu_torch.ops.vmem_attention import check_shapes, vmem_attention
from vit4hep_tpu_torch.utils.misc import f32

_NEG_INF = -1e30
_IMPLS = ("auto", "xla", "fused", "flash", "vmem")


def _check_impl(impl):
    if impl not in _IMPLS:
        raise ValueError(f"Unknown attention impl '{impl}'")


def xla_attention(q, k, v, mask=None, scale=None):
    """softmax(q k^T * scale) v on (B, H, N, D) tensors; mask True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(f32(q), f32(k).transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    weights = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    weights = weights / weights.sum(dim=-1, keepdim=True)
    out = torch.matmul(f32(weights.to(v.dtype)), f32(v))
    return out if out.dtype == v.dtype else out.to(v.dtype)


def dot_product_attention(q, k, v, mask=None, impl="auto", scale=None):
    """Scaled dot-product attention on (B, H, N, D) tensors."""
    _check_impl(impl)
    n, d = q.shape[-2], q.shape[-1]
    if impl == "auto":
        kernel_ok = mask is None or mask.ndim == 2
        if kernel_ok and 288 <= n <= 1024:
            impl = "vmem"
        elif kernel_ok and n > 1024:
            impl = "flash"
        else:
            impl = "xla"
    if impl == "xla":
        return xla_attention(q, k, v, mask, scale=scale)
    if impl == "fused":  # the native-layout kernel only; JAX raises here too
        raise ValueError("Unknown attention impl 'fused' for separated q, k, v")
    check_shapes(f"attn_impl '{impl}'", q, k, v)
    if impl == "flash":
        return flash_attention(q, k, v, mask, 256, 256, scale)
    if n > 1024 or 16 * n * d + 20 * n * n > 120 * 1024 * 1024:
        raise ValueError(f"attn_impl 'vmem': N={n} x D={d} exceeds the one-shot kernel's "
                         "VMEM working set; use attn_impl 'flash' (or 'auto')")
    return vmem_attention(q, k, v, mask, scale)


def fused_fits(n, hd, num_heads) -> bool:
    """The TPU kernel's VMEM working-set bound, which the dispatch keeps
    (``vit4hep_tpu/ops/attention.py:127-138``); head_dim <= 64 is its
    head-packed body."""
    packed = hd // num_heads <= 64
    score_mult = num_heads if packed else 1
    packed_panels = 14 * num_heads * n * hd if packed else 0
    return n <= 2048 and (16 * n * hd + 20 * n * n * score_mult + packed_panels
                          <= 120 * 1024 * 1024)


def qkv_attention(qkv, num_heads, mask=None, impl="auto", scale=None):
    """Attention from the qkv projection's native (B, N, 3*H*D) layout
    (q, k, v blocks of H heads each). Returns the merged (B, N, H*D)
    context."""
    _check_impl(impl)
    b, n, three_hd = qkv.shape
    fits = fused_fits(n, three_hd // 3, num_heads)
    if impl == "auto":
        kernel_ok = mask is None or mask.ndim == 2
        if kernel_ok and n >= 128 and fits:
            impl = "fused"
        elif kernel_ok and n >= 128:
            impl = "flash"
        else:
            impl = "xla"
    if impl == "fused":
        if not fits:
            raise ValueError(f"attn_impl 'fused': N={n} tokens x head_dim "
                             f"{three_hd // 3 // num_heads} exceeds the fused-layout kernel's "
                             "working-set bound; use attn_impl 'flash' (or 'auto')")
        return fused_qkv_attention(qkv, num_heads, mask, scale)
    if impl == "flash" and (mask is None or mask.ndim == 2) \
            and flash_qkv_fits(n, three_hd // 3, num_heads=num_heads):
        return flash_qkv_attention(qkv, num_heads, mask, scale)
    d = three_hd // 3 // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
    out = dot_product_attention(q, k, v, mask, impl=impl, scale=scale)
    return out.permute(0, 2, 1, 3).reshape(b, n, num_heads * d)
