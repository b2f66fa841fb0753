"""The adaLN-MLP half of the DiT block (port of ``vit4hep_tpu/ops/fused_mlp.py``,
kernel K9): ``x + gate * (W2 gelu_tanh(W1 (LN(x) (1 + scale) + shift) + b1)
+ b2)``, LayerNorm without affine, eps 1e-6.

:func:`fused_mlp_half` takes the JAX function's arguments: x (B, T, H),
shift/scale/gate (B, H) (row views of the adaLN panel are taken in place),
w1 (H, F), b1 (F,), w2 (F, H), b2 (H,) in the Dense layout. It is a
``torch.autograd.Function`` whose backward is the VJP of the plain version
:func:`mlp_half_plain` from the saved inputs (JAX ``_bwd``, ``:151-154``):
forward-only as a kernel, as on the TPU, and the gradients reach the f32
weights the caller passes.

On CPU tensors the forward is :func:`mlp_half_plain` (f32 products, the TPU
kernel's interpret mode). On CUDA tensors it is a chain of three launches
of the hand-written kernels in ``csrc/vit_forward.cu``, counted under
:data:`MODLN` and :data:`GEMM` (apart from K2v's counts of the same kernels):
``vit_modln`` (LayerNorm + modulate, bf16 out), ``vit_gemm`` with its bias +
tanh-GELU epilogue (fc1, bf16 hidden) and ``vit_gemm`` with its gated
residual epilogue (fc2: x + gate * (. + b2), f32 out). Products take bf16
multiplicands with f32 accumulation (the TPU kernel's ``mm_dtype``,
``:117``); the weights are cast to bf16 per call.

What bounds it on the card: at the ds3 training shape (x (64, 450, 480),
F 1920) the two products are 106 GFLOP, 0.107 ms at the bf16 tensor-core
peak, against 114 MB of x, out and weights (0.034 ms at 3.35 TB/s): it is
bound by operations. The TPU kernel keeps the (rows, F) hidden in VMEM; this
chain writes it to device memory in bf16 and reads it back (221 MB more at
that shape), which fits a CTA no better than K2v's block does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops import fused_dit_block as fdb

_LN_EPS = 1e-6
MODLN = _cuda.LaunchCounter("mlp_modln")
GEMM = _cuda.LaunchCounter("mlp_gemm")


def _mm(a, w, mm_dtype):
    return a.to(mm_dtype).float() @ w.to(mm_dtype).float()


def mlp_half_plain(x, shift, scale, gate, w1, b1, w2, b2, mm_dtype=torch.float32):
    """``mlp_half_reference``, its products on ``mm_dtype``-rounded
    multiplicands with f32 accumulation (with bf16, the rounding points of
    the kernel chain: the modulated LayerNorm and the GELU hidden)."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    u = (x - mu) * torch.rsqrt(var + _LN_EPS)
    h = u * (1 + scale[:, None, :]) + shift[:, None, :]
    h = F.gelu(_mm(h, w1, mm_dtype) + b1, approximate="tanh")
    h = _mm(h, w2, mm_dtype) + b2
    return x + gate[:, None, :] * h


def modln(x, shift, scale, n_tok):
    """K2v's modulated LayerNorm kernel (``fused_dit_block.modln``), counted
    under :data:`MODLN`."""
    return fdb._modln(MODLN, x, shift, scale, n_tok)


def linear(a, w, bias, epilogue, out=None, gate=None, n_tok=1, resid=None):
    """K2v's product kernel (``fused_dit_block.linear``), counted under
    :data:`GEMM`."""
    return fdb._gemm(GEMM, "fused_mlp_half", a, w, bias, epilogue, out, None, gate, resid, None,
                     n_tok)


def mlp_half_kernel(x, shift, scale, gate, w1, b1, w2, b2):
    """The chain on the card: x (B, T, H) f32; shift/scale/gate (B, H)
    views with a unit column stride; weights in the Dense layout, f32 or
    bf16. Returns a new (B, T, H) f32."""
    b, t, hdim = x.shape
    _cuda.require_cuda("fused_mlp_half", x)
    xr = x.view(b * t, hdim)
    w1b, w2b = (w.to(torch.bfloat16).contiguous() for w in (w1, w2))
    hid = linear(modln(xr, shift, scale, t), w1b, b1, fdb.EPI_BIAS_GELU, n_tok=t)
    out = linear(hid, w2b, b2, fdb.EPI_GATED_RESID, out=torch.empty_like(xr), gate=gate,
                 n_tok=t, resid=xr)
    return out.view(b, t, hdim)


class _FusedMlpHalf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        return mlp_half_plain(*args) if args[0].device.type == "cpu" else mlp_half_kernel(*args)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mlp_half_plain(*inputs)
        return torch.autograd.grad(out, inputs, g)


def fused_mlp_half(x, shift, scale, gate, w1, b1, w2, b2):
    """x + gate * MLP(modulate(LN x)) of a DiT block, differentiable (plain
    VJP)."""
    return _FusedMlpHalf.apply(x.contiguous(), shift, scale, gate, w1, b1, w2, b2)
