"""One-shot exact-softmax attention on separated (B, H, N, D) tensors,
forward and backward (port of ``vit4hep_tpu/ops/vmem_attention.py``,
kernel K8).

:func:`vmem_attention` takes the JAX function's arguments: q, k, v of one
shape (B, H, N, D), an optional shared (N, N) boolean mask (True = attend)
and the logit scale. It is a ``torch.autograd.Function``: the forward keeps
the log-sum-exp (B, H, N) and the backward rebuilds p = exp(s - lse) from
the same products, with K8's own row term rowsum(dp * p).

Products take ``mm_dtype`` multiplicands with f32 accumulation, as the TPU
kernel's ``mm_dtype`` does: f32 in the plain versions on the CPU (the
kernel's interpret mode, which the tests hold against JAX), bf16 on the card
(its compiled precision; ``chip_smoke.py`` holds the kernels against the
plain versions on bf16-rounded multiplicands). On CPU tensors the wrapper
runs :func:`vmem_fwd_plain` and :func:`vmem_bwd_plain`; on CUDA tensors it
launches the kernels of ``csrc/vmem_attention.cu`` or raises: the forward,
then for the gradient the dQ pass (which also writes the row term) and the
dK/dV pass, each with its own launch counter. q, k and v may be strided
views with one stride set and a unit column stride (the ViT's split of its
qkv panel), so the kernels read them in place.
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.fused_qkv_attention import head_dim_not_ported, mask_arg

_NEG_INF = -1e30
_P, _I, _LL, _F = _cuda.P, _cuda.I, _cuda.LL, _cuda.F
_STRIDES = [_LL, _LL, _LL]
_DIMS = [_I, _I, _I, _I, _F, _P]  # B, H, n, d, scale, stream
_SIGNATURES = {
    "vmem_attention_fwd": [_P, _P, _P, *_STRIDES, _P, _P, _P, *_DIMS],
    "vmem_attention_bwd_dq": [_P, _P, _P, *_STRIDES, _P, *_STRIDES, _P, _P, _P, _P, *_DIMS],
    "vmem_attention_bwd_dkv": [_P, _P, _P, *_STRIDES, _P, *_STRIDES, _P, _P, _P, _P, _P, *_DIMS],
}

FWD = _cuda.LaunchCounter("vmem_attn_fwd")
BWD_DQ = _cuda.LaunchCounter("vmem_attn_bwd_dq")
BWD_DKV = _cuda.LaunchCounter("vmem_attn_bwd_dkv")


def _lib():
    return _cuda.load("vmem_attention", _SIGNATURES)


def _mm(a, b, mm_dtype):
    """a @ b on multiplicands rounded to ``mm_dtype``, accumulated in f32."""
    return torch.matmul(a.to(mm_dtype).float(), b.to(mm_dtype).float())


def _scores(q, k, scale, mask, mm_dtype):
    s = _mm(q, k.transpose(-1, -2), mm_dtype) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def vmem_fwd_plain(q, k, v, scale, mask=None, mm_dtype=torch.float32):
    """``_oneshot_kernel``: (out (B, H, N, D) in q's dtype, lse (B, H, N)
    f32). The exact softmax of each row; p enters the P . V product rounded
    to ``mm_dtype``."""
    s = _scores(q, k, scale, mask, mm_dtype)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (_mm(p, v, mm_dtype) / l_safe).to(q.dtype), (m + torch.log(l_safe))[..., 0]


def vmem_bwd_plain(q, k, v, g, lse, scale, mask=None, mm_dtype=torch.float32):
    """``_bwd_kernel``: (dq, dk, dv) from the forward's lse, with p =
    exp(s - lse) rebuilt on the same products and the row term
    rowsum(dp * p)."""
    p = torch.exp(_scores(q, k, scale, mask, mm_dtype) - lse[..., None])
    dv = _mm(p.transpose(-1, -2), g, mm_dtype)
    dp = _mm(g, v.transpose(-1, -2), mm_dtype)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return (_mm(ds, k, mm_dtype).to(q.dtype), _mm(ds.transpose(-1, -2), q, mm_dtype).to(q.dtype),
            dv.to(q.dtype))


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def kernel_strides(name, t):
    """(sb, sh, sn) of a (B, H, N, D) f32 CUDA tensor with a unit column stride."""
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must have stride 1, got strides {t.stride()}")
    return t.stride(0), t.stride(1), t.stride(2)


def kernel_qkv_args(name, q, k, v, mask):
    """(B, H, N, D, the shared strides of q, k, v, the mask's uint8 view
    and pointer) for a launch; raises on what the kernels do not take."""
    b, h, n, d = check_shapes(name, q, k, v, mask)
    head_dim_not_ported(name, d)
    if b > 65535 or h > 65535:
        raise ValueError(f"{name}: batch {b} or {h} heads (max 65535) out of the kernels' range")
    strides = kernel_strides(name, q)
    if kernel_strides(name, k) != strides or kernel_strides(name, v) != strides or \
            not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v need one device and one stride set")
    mask, mask_ptr = mask_arg(name, mask, n, q.device)
    return b, h, n, d, strides, mask, mask_ptr


def vmem_fwd_kernel(q, k, v, scale, mask=None):
    """Launch the forward kernel: (out (B, H, N, D) f32, lse (B, H, N) f32)."""
    b, h, n, d, strides, mask, mask_ptr = kernel_qkv_args("vmem_attention_fwd", q, k, v, mask)
    out = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    code = _lib().vmem_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides, mask_ptr,
                                     out.data_ptr(), lse.data_ptr(), b, h, n, d, float(scale),
                                     _cuda.stream())
    _cuda.check(code, "vmem_attention_fwd")
    FWD.add()
    return out, lse


def _bwd_args(name, q, k, v, g, lse, mask):
    b, h, n, d, strides, mask, mask_ptr = kernel_qkv_args(name, q, k, v, mask)
    if tuple(g.shape) != (b, h, n, d) or tuple(lse.shape) != (b, h, n):
        raise ValueError(f"{name}: g {tuple(g.shape)} / lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    _cuda.require_cuda(name, lse)
    return b, h, n, d, strides, kernel_strides(name, g), mask, mask_ptr


def vmem_bwd_dq_kernel(q, k, v, g, lse, scale, mask=None):
    """Launch the dQ pass: (dq (B, H, N, D) f32, the row term rowsum(dp * p)
    (B, H, N) f32)."""
    b, h, n, d, strides, gstrides, mask, mask_ptr = _bwd_args("vmem_attention_bwd_dq", q, k, v,
                                                              g, lse, mask)
    dq = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    rowterm = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    code = _lib().vmem_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                        g.data_ptr(), *gstrides, lse.data_ptr(), mask_ptr,
                                        dq.data_ptr(), rowterm.data_ptr(), b, h, n, d,
                                        float(scale), _cuda.stream())
    _cuda.check(code, "vmem_attention_bwd_dq")
    BWD_DQ.add()
    return dq, rowterm


def vmem_bwd_dkv_kernel(q, k, v, g, lse, rowterm, scale, mask=None):
    """Launch the dK/dV pass from the dQ pass's row term: (dk, dv) (B, H, N,
    D) f32."""
    b, h, n, d, strides, gstrides, mask, mask_ptr = _bwd_args("vmem_attention_bwd_dkv", q, k, v,
                                                              g, lse, mask)
    _cuda.require_cuda("vmem_attention_bwd_dkv", rowterm)
    if rowterm.shape != lse.shape:
        raise ValueError("vmem_attention_bwd_dkv: the row term's shape differs from lse's")
    dk = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    code = _lib().vmem_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                         g.data_ptr(), *gstrides, lse.data_ptr(),
                                         rowterm.data_ptr(), mask_ptr, dk.data_ptr(),
                                         dv.data_ptr(), b, h, n, d, float(scale), _cuda.stream())
    _cuda.check(code, "vmem_attention_bwd_dkv")
    BWD_DKV.add()
    return dk, dv


def vmem_bwd_kernel(q, k, v, g, lse, scale, mask=None):
    """(dq, dk, dv) through the two backward kernels."""
    dq, rowterm = vmem_bwd_dq_kernel(q, k, v, g, lse, scale, mask)
    return (dq, *vmem_bwd_dkv_kernel(q, k, v, g, lse, rowterm, scale, mask))


class _VmemAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mask):
        if q.device.type == "cpu":
            out, lse = vmem_fwd_plain(q, k, v, scale, mask)
        else:
            out, lse = vmem_fwd_kernel(q, k, v, scale, mask)
        ctx.save_for_backward(q, k, v, lse)
        ctx.scale, ctx.mask = scale, mask
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = vmem_bwd_plain(q, k, v, g, lse, ctx.scale, ctx.mask)
        else:
            grads = vmem_bwd_kernel(q, k, v, g if g.stride(3) == 1 else g.contiguous(), lse,
                                    ctx.scale, ctx.mask)
        return (*grads, None, None)


def check_shapes(name, q, k, v, mask=None):
    """(B, H, N, D) of q, k, v of one shape; raises a ValueError for q and k
    of different lengths (the one-shot and flash kernels attend a sequence
    to itself: JAX reshapes k to q's length and fails) and for a mask that
    is not a shared 2-D one."""
    if q.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, N, D) tensors, got q {tuple(q.shape)}")
    if k.shape[-2] != q.shape[-2]:
        raise ValueError(f"{name}: q has {q.shape[-2]} tokens and k {k.shape[-2]}; the kernel "
                         "attends a sequence to itself (use attn_impl 'xla' for cross-attention)")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must have one shape")
    if mask is not None and mask.dim() != 2:
        raise ValueError(f"{name} supports a shared (N, N) mask")
    return tuple(q.shape)


def vmem_attention(q, k, v, mask=None, scale=None):
    """softmax(q k^T * scale) v on (B, H, N, D) tensors, differentiable;
    ``mask`` an optional shared (N, N) bool on q's device, True = attend;
    ``scale`` overrides 1/sqrt(D). bf16 q, k, v (a ViT with
    ``compute_dtype: bfloat16``) run the f32 arm on their values and the
    result is rounded to bf16, as JAX's kernel stores it: that arm already
    multiplies in bf16 on the card."""
    if q.dtype == torch.bfloat16:
        return vmem_attention(q.float(), k.float(), v.float(), mask, scale).to(torch.bfloat16)
    _, _, n, d = check_shapes("vmem_attention", q, k, v, mask)
    if mask is not None:
        mask_arg("vmem_attention", mask, n, q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type != "cpu" and not (q.stride() == k.stride() == v.stride()
                                       and q.stride(3) == 1):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return _VmemAttention.apply(q, k, v, scale, mask)
