"""Streaming flash attention on separated (B, H, N, D) tensors, forward and
backward (port of ``vit4hep_tpu/ops/flash_attention.py``, kernel K7).

:func:`flash_attention` takes the JAX function's arguments: q, k, v of one
shape (B, H, N, D) (self-attention: one N), an optional shared (N, N)
boolean mask (True = attend), the TPU kernel's block sizes and the logit
scale. It is a ``torch.autograd.Function``: the forward keeps the
log-sum-exp (B, H, N); the backward takes delta = rowsum(dO * O) (plain
PyTorch, as JAX computes it in plain XLA) and runs the dK/dV and dQ passes.

Everything is f32, as the TPU kernel computes it. The pad guard and JAX's
masked-key semantics hold on both sides: keys past N weigh exactly 0; a row
whose every key is masked gets the mean of V over the N real keys in the
forward (lse = -1e30 + log N), and the backward weighs every masked key 0
(``where(valid, exp(s - lse), 0)``), so that row adds nothing to dK and dV
and its dQ is 0.

On CPU tensors the wrapper runs :func:`flash_fwd_plain` and
:func:`flash_bwd_plain`; on CUDA tensors it launches the kernels of
``csrc/flash_attention.cu`` or raises: the forward, the dK/dV pass and the
dQ pass, each with its own launch counter. q, k and v may be strided views
with one stride set and a unit column stride (the ViT's split of its qkv
panel), which the kernels read in place; the upstream gradient has its own
strides. Outputs are contiguous (B, H, N, D) f32.
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.fused_qkv_attention import mask_arg
from vit4hep_tpu_torch.ops.vmem_attention import check_shapes, kernel_qkv_args, kernel_strides

_NEG_INF = -1e30
_P, _I, _LL, _F = _cuda.P, _cuda.I, _cuda.LL, _cuda.F
_STRIDES = [_LL, _LL, _LL]
_DIMS = [_I, _I, _I, _I, _F, _P]  # B, H, n, d, scale, stream
_SIGNATURES = {
    "flash_attention_fwd": [_P, _P, _P, *_STRIDES, _P, _P, _P, *_DIMS],
    "flash_attention_bwd_dkv": [_P, _P, _P, *_STRIDES, _P, *_STRIDES, _P, _P, _P, _P, _P,
                                *_DIMS],
    "flash_attention_bwd_dq": [_P, _P, _P, *_STRIDES, _P, *_STRIDES, _P, _P, _P, _P, *_DIMS],
}

FWD = _cuda.LaunchCounter("flash_attn_fwd")
BWD_DKV = _cuda.LaunchCounter("flash_attn_bwd_dkv")
BWD_DQ = _cuda.LaunchCounter("flash_attn_bwd_dq")


def _lib():
    return _cuda.load("flash_attention", _SIGNATURES)


def _scores(q, k, scale):
    """The scaled scores (B, H, N, N) f32, a new tensor the caller may
    overwrite (the plain versions work in place: at 13,500 tokens one such
    tensor of a batch element's 6 heads is 4.4 GB)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)).mul_(scale)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def flash_fwd_plain(q, k, v, scale, mask=None):
    """``_fwd_kernel``: (out (B, H, N, D) in q's dtype, lse (B, H, N) f32),
    the exact softmax in f32 (the online softmax's result); a masked score
    is -1e30, so a wholly masked row is the mean of V with lse = -1e30 +
    log N."""
    p = _scores(q, k, scale)
    if mask is not None:
        p.masked_fill_(~mask, _NEG_INF)
    m = p.amax(-1, keepdim=True)
    p.sub_(m).exp_()
    l = p.sum(-1, keepdim=True)  # noqa: E741
    return (torch.matmul(p, v.float()) / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_plain(q, k, v, g, out, lse, scale, mask=None):
    """``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``: (dq, dk, dv) in q's dtype
    from the forward's output and lse, with delta = rowsum(dO * O) and p =
    where(valid, exp(s - lse), 0)."""
    g = g.float()
    p = _scores(q, k, scale).sub_(lse[..., None]).exp_()
    if mask is not None:
        p.masked_fill_(~mask, 0.0)
    dv = torch.matmul(p.transpose(-1, -2), g)
    ds = torch.matmul(g, v.float().transpose(-1, -2))
    ds.sub_(delta_plain(g, out)[..., None]).mul_(p).mul_(scale)
    del p
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def delta_plain(g, out):
    """rowsum(dO * O) per (batch, head, query): (B, H, N) f32."""
    return (g.float() * out.float()).sum(-1)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def flash_fwd_kernel(q, k, v, scale, mask=None):
    """Launch the forward kernel: (out (B, H, N, D) f32, lse (B, H, N) f32)."""
    b, h, n, d, strides, mask, mask_ptr = kernel_qkv_args("flash_attention_fwd", q, k, v, mask)
    out = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    code = _lib().flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                      mask_ptr, out.data_ptr(), lse.data_ptr(), b, h, n, d,
                                      float(scale), _cuda.stream())
    _cuda.check(code, "flash_attention_fwd")
    FWD.add()
    return out, lse


def _bwd_args(name, q, k, v, g, lse, delta, mask):
    b, h, n, d, strides, mask, mask_ptr = kernel_qkv_args(name, q, k, v, mask)
    if tuple(g.shape) != (b, h, n, d) or tuple(lse.shape) != (b, h, n) or \
            tuple(delta.shape) != (b, h, n):
        raise ValueError(f"{name}: g {tuple(g.shape)} / lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} do not match q {tuple(q.shape)}")
    _cuda.require_cuda(name, lse, delta)
    return b, h, n, d, strides, kernel_strides(name, g), mask, mask_ptr


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask=None):
    """Launch the dK/dV pass: (dk, dv) (B, H, N, D) f32."""
    b, h, n, d, strides, gstrides, mask, mask_ptr = _bwd_args(
        "flash_attention_bwd_dkv", q, k, v, g, lse, delta, mask)
    dk = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    code = _lib().flash_attention_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                          g.data_ptr(), *gstrides, lse.data_ptr(),
                                          delta.data_ptr(), mask_ptr, dk.data_ptr(),
                                          dv.data_ptr(), b, h, n, d, float(scale),
                                          _cuda.stream())
    _cuda.check(code, "flash_attention_bwd_dkv")
    BWD_DKV.add()
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask=None):
    """Launch the dQ pass: dq (B, H, N, D) f32."""
    b, h, n, d, strides, gstrides, mask, mask_ptr = _bwd_args(
        "flash_attention_bwd_dq", q, k, v, g, lse, delta, mask)
    dq = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    code = _lib().flash_attention_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), *strides,
                                         g.data_ptr(), *gstrides, lse.data_ptr(),
                                         delta.data_ptr(), mask_ptr, dq.data_ptr(), b, h, n, d,
                                         float(scale), _cuda.stream())
    _cuda.check(code, "flash_attention_bwd_dq")
    BWD_DQ.add()
    return dq


def flash_bwd_kernel(q, k, v, g, out, lse, scale, mask=None):
    """(dq, dk, dv) through delta and the two backward kernels."""
    delta = delta_plain(g, out)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask)
    return flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask), dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, mask):
        if q.device.type == "cpu":
            out, lse = flash_fwd_plain(q, k, v, scale, mask)
        else:
            out, lse = flash_fwd_kernel(q, k, v, scale, mask)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.mask = scale, mask
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = flash_bwd_plain(q, k, v, g, out, lse, ctx.scale, ctx.mask)
        else:
            grads = flash_bwd_kernel(q, k, v, g if g.stride(3) == 1 else g.contiguous(), out,
                                     lse, ctx.scale, ctx.mask)
        return (*grads, None, None)


def flash_attention(q, k, v, mask=None, block_q=256, block_k=256, scale=None):
    """softmax(q k^T * scale) v on (B, H, N, D) tensors, differentiable;
    ``mask`` an optional shared (N, N) bool on q's device, True = attend;
    ``scale`` overrides 1/sqrt(D). ``block_q``/``block_k`` are the TPU
    kernel's blocks, accepted for its signature: the CUDA kernels stream
    64-row tiles, and the function does not depend on the blocking."""
    del block_q, block_k
    _, _, n, d = check_shapes("flash_attention", q, k, v, mask)
    if mask is not None:
        mask_arg("flash_attention", mask, n, q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type != "cpu" and not (q.stride() == k.stride() == v.stride()
                                       and q.stride(3) == 1):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, scale, mask)
