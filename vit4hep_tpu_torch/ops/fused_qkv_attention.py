"""Attention on the qkv projection's native layout, forward and backward
(port of ``vit4hep_tpu/ops/fused_qkv_attention.py``, kernel K1).

:func:`fused_qkv_attention` takes the JAX function's arguments: the
``(B, N, 3*H*D)`` qkv panel (last axis ordered [q/k/v, head, dim]), the
head count, an optional shared ``(N, N)`` boolean mask (True = attend) and
the logit scale. It returns the merged ``(B, N, H*D)`` context and is a
``torch.autograd.Function``: the forward keeps the per-head log-sum-exp
``(B, H, N)`` and the backward rebuilds the probabilities from it and emits
``dqkv`` in the native layout, as the TPU kernels do.

On CPU tensors it runs the plain versions :func:`attention_fwd_plain` and
:func:`attention_bwd_plain` (f32 matmuls and softmax; the backward is the
5-product VJP of ``_bwd_kernel_masked``). On CUDA tensors it launches the
hand-written kernels of ``csrc/qkv_attention.cu`` and
``csrc/qkv_attention_bwd.cu`` or raises: the forward kernel, then for the
gradient a delta pre-pass (rowsum(dO * O)) and the dK/dV and dQ kernels. Each kernel has its own wrapper and launch counter,
which counts masked and unmasked launches alike. The kernels keep the f32
contract for head dims up to :data:`MAX_HEAD_DIM`, at any N, with or
without the mask (each product runs as three TF32 tensor-core products,
``csrc/qkv_fwd_tf32.cuh`` and ``csrc/qkv_bwd_tf32.cuh``). The
mask goes to them as a contiguous ``uint8`` view on qkv's device and
enters each score as ``where(mask, s * scale, -1e30)``, the TPU bodies'
``_fused_kernel_masked``, ``_packed_kernel_masked`` and
``_bwd_kernel_masked``. A row whose every key is masked gets the mean of V
and JAX's backward for it (``csrc/qkv_attention.cu`` explains the one
adjustment the kernels make there).

The panel may also be bfloat16, as a ViT with ``compute_dtype: bfloat16``
hands it over (JAX's kernels take it as it is: bf16 multiplicands with f32
accumulation, f32 softmax statistics, the context and ``dqkv`` stored in
bf16, the lse in f32). On the card a bf16 panel goes to K1's bf16 arm
(``csrc/qkv_attention_bf16.cu``: the forward, the delta pre-pass and the
dK/dV and dQ passes on bf16 wgmma, each with its own wrapper and launch
counter, ``FWD_BF16`` ...); on the CPU the plain versions run and return
the context and ``dqkv`` in bf16. Their ``mm_dtype`` rounds the products'
multiplicands (p and ds included) as JAX's ``mm_dtype`` does: f32 on the
CPU (JAX in interpret mode), bf16 as the card's oracle of the bf16 arm. Any
other dtype raises.
"""

from __future__ import annotations

import torch

from vit4hep_tpu_torch.ops import _cuda

_NEG_INF = -1e30
MAX_HEAD_DIM = 128
_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_SIGNATURES = {
    "qkv_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "qkv_attention_bwd_delta": [_P, _P, _P, _I, _I, _I, _I, _P],
}
_BWD_SIGNATURES = {
    "qkv_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "qkv_attention_bwd_dq": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}
_BF16_SIGNATURES = {
    "qkv_attention_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "qkv_attention_bwd_delta_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "qkv_attention_bwd_dkv_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "qkv_attention_bwd_dq_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

FWD = _cuda.LaunchCounter("qkv_attn_fwd")
BWD_DELTA = _cuda.LaunchCounter("qkv_attn_bwd_delta")
BWD_DKV = _cuda.LaunchCounter("qkv_attn_bwd_dkv")
BWD_DQ = _cuda.LaunchCounter("qkv_attn_bwd_dq")
FWD_BF16 = _cuda.LaunchCounter("qkv_attn_fwd_bf16")
BWD_DELTA_BF16 = _cuda.LaunchCounter("qkv_attn_bwd_delta_bf16")
BWD_DKV_BF16 = _cuda.LaunchCounter("qkv_attn_bwd_dkv_bf16")
BWD_DQ_BF16 = _cuda.LaunchCounter("qkv_attn_bwd_dq_bf16")


def _lib():
    return _cuda.load("qkv_attention", _SIGNATURES)


def _bwd_lib():
    """The dK/dV and dQ passes, a library of their own
    (``csrc/qkv_attention_bwd.cu``)."""
    return _cuda.load("qkv_attention_bwd", _BWD_SIGNATURES)


def _bf16_lib():
    """K1's bf16 arm, a library of its own (``csrc/qkv_attention_bf16.cu``)."""
    return _cuda.load("qkv_attention_bf16", _BF16_SIGNATURES)


def _check_dtype(name, qkv):
    """Raise unless the panel is float32 or bfloat16 (the kernels' arms)."""
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: qkv has dtype {qkv.dtype}; K1 takes float32 or bfloat16")


def _dims(qkv, num_heads):
    b, n, three_hd = qkv.shape
    d = three_hd // 3 // num_heads
    if 3 * num_heads * d != three_hd:
        raise ValueError(f"qkv last dim {three_hd} != 3*{num_heads}*head_dim")
    return b, n, d


def _heads(t, num_heads, parts):
    """(B, N, parts*H*D) -> `parts` tensors of (B, H, N, D)."""
    b, n, width = t.shape
    d = width // parts // num_heads
    return t.reshape(b, n, parts, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(*heads):
    """`parts` tensors of (B, H, N, D) -> (B, N, parts*H*D)."""
    b, h, n, d = heads[0].shape
    return torch.stack(heads, 0).permute(1, 3, 0, 2, 4).reshape(b, n, len(heads) * h * d)


def _mm(a, b, mm_dtype):
    """a @ b on ``mm_dtype`` multiplicands with f32 accumulation (a plain
    f32 product for f32)."""
    return torch.matmul(a.to(mm_dtype).float(), b.to(mm_dtype).float())


def _scores(q, k, scale, mask, mm_dtype=torch.float32):
    s = _mm(q, k.transpose(-1, -2), mm_dtype) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    return s


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the kernels' oracles)
# ---------------------------------------------------------------------------
def attention_fwd_plain(qkv, num_heads, scale, mask=None, mm_dtype=torch.float32):
    """(context (B, N, H*D) in qkv's dtype, lse (B, H, N) f32): f32 softmax
    statistics and accumulation, the products on ``mm_dtype`` multiplicands
    (p rounded to it for the P . V product)."""
    q, k, v = _heads(qkv.float(), num_heads, 3)
    s = _scores(q, k, scale, mask, mm_dtype)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = _merge(_mm(p, v, mm_dtype) / l_safe)
    return out.to(qkv.dtype), (m + torch.log(l_safe))[..., 0]


def attention_bwd_plain(qkv, g, lse, num_heads, scale, mask=None, mm_dtype=torch.float32,
                        out=None):
    """dqkv (B, N, 3*H*D) in qkv's dtype from the qkv panel, the upstream
    gradient of the context (B, N, H*D) and the forward's lse: per head P =
    exp(s - lse), dV = P^T dO, dP = dO V^T, dS = P (dP - delta) * scale,
    dQ = dS K, dK = dS^T Q, each product on ``mm_dtype`` multiplicands (P
    and dS rounded to it, as JAX's ``mm``). delta is JAX's rowsum(dP P);
    with the forward's context ``out``, the kernels' rowsum(dO O), times N
    on a wholly masked row (lse -1e30), which equals it but for the
    context's rounding (the bf16 arm's oracle: its context is bf16, and a
    wholly masked row's delta carries N times that rounding)."""
    q, k, v = _heads(qkv.float(), num_heads, 3)
    (gh,) = _heads(g.float(), num_heads, 1)
    p = torch.exp(_scores(q, k, scale, mask, mm_dtype) - lse[..., None])
    dv = _mm(p.transpose(-1, -2), gh, mm_dtype)
    dp = _mm(gh, v.transpose(-1, -2), mm_dtype)
    if out is None:
        delta = (dp * p).sum(-1, keepdim=True)
    else:
        delta = delta_plain(g, out, num_heads)[..., None]
        delta = torch.where(lse[..., None] == _NEG_INF, delta * q.shape[-2], delta)
    ds = p * (dp - delta) * scale
    dq = _mm(ds, k, mm_dtype)
    dk = _mm(ds.transpose(-1, -2), q, mm_dtype)
    return _merge(dq, dk, dv).to(qkv.dtype)


def delta_plain(g, out, num_heads):
    """rowsum(dO * O) per (batch, head, query): (B, H, N) f32."""
    b, n, hd = g.shape
    return (g.float() * out.float()).reshape(b, n, num_heads, hd // num_heads).sum(-1) \
        .permute(0, 2, 1).contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def check_kernel_args(name, qkv, num_heads):
    """(B, N, head_dim) of a (B, N, 3*H*D) qkv panel the kernels take;
    raises ValueError on a width that is not 3 * H * D or a batch or head
    count above the grid's 65535, and NotImplementedError on a head dim
    above MAX_HEAD_DIM (not ported yet: :func:`head_dim_not_ported`)."""
    b, n, d = _dims(qkv, num_heads)
    head_dim_not_ported(name, d)
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"{name}: batch {b} or {num_heads} heads above the grid's 65535")
    return b, n, d


def head_dim_not_ported(name, d):
    """Raise NotImplementedError for a head dim the kernels do not take yet:
    they are instantiated up to MAX_HEAD_DIM (128), while JAX's kernels take
    any head dim (ROADMAP.md, queue 2: head dims 129-256)."""
    if d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"{name}: head_dim {d} above {MAX_HEAD_DIM} is not ported to the card's kernels yet "
            "(ROADMAP.md, queue 2: head dims 129-256)")


def mask_arg(name, mask, n, device):
    """The optional shared (N, N) bool mask as the kernels read it: (a
    contiguous uint8 view, one byte each, 1 = attend, to keep alive across
    the launch; its pointer), or (None, None); raises unless it is a bool
    (N, N) tensor on ``device``."""
    if mask is None:
        return None, None
    if mask.dtype != torch.bool or tuple(mask.shape) != (n, n):
        raise ValueError(f"{name}: expected a bool ({n}, {n}) mask, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if mask.device != device:
        raise ValueError(f"{name}: the mask is on {mask.device}, qkv on {device}")
    mask = mask.contiguous().view(torch.uint8)
    return mask, mask.data_ptr()


def attention_fwd_kernel(qkv, num_heads, scale, mask=None, out=None, lse=None):
    """Launch the forward kernel: (context (B, N, H*D) f32, lse (B, H, N)
    f32); ``mask`` an optional shared (N, N) bool on qkv's device. ``out``
    and ``lse`` may be given as contiguous f32 buffers of those shapes (the
    training forward writes its saved residuals in place)."""
    _cuda.require_cuda("qkv_attention_fwd", qkv)
    b, n, d = check_kernel_args("qkv_attention_fwd", qkv, num_heads)
    mask, mask_ptr = mask_arg("qkv_attention_fwd", mask, n, qkv.device)
    if out is None:
        out = torch.empty((b, n, num_heads * d), dtype=torch.float32, device=qkv.device)
    if lse is None:
        lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    _cuda.require_cuda("qkv_attention_fwd", qkv, out, lse)
    if tuple(out.shape) != (b, n, num_heads * d) or tuple(lse.shape) != (b, num_heads, n):
        raise ValueError(f"qkv_attention_fwd: out {tuple(out.shape)} / lse {tuple(lse.shape)} "
                         f"do not match qkv {tuple(qkv.shape)} with {num_heads} heads")
    code = _lib().qkv_attention_fwd(qkv.data_ptr(), mask_ptr, out.data_ptr(), lse.data_ptr(),
                                    b, n, num_heads, d, float(scale), _cuda.stream())
    _cuda.check(code, "qkv_attention_fwd")
    FWD.add()
    return out, lse


def _check_bwd_args(name, qkv, g, lse, num_heads):
    b, n, d = check_kernel_args(name, qkv, num_heads)
    if tuple(g.shape) != (b, n, num_heads * d) or tuple(lse.shape) != (b, num_heads, n):
        raise ValueError(f"{name}: g {tuple(g.shape)} / lse {tuple(lse.shape)} do not match "
                         f"qkv {tuple(qkv.shape)} with {num_heads} heads")
    return b, n, d


def attention_bwd_delta_kernel(g, out, num_heads):
    """Launch the delta pre-pass: rowsum(dO * O), (B, H, N) f32."""
    _cuda.require_cuda("qkv_attention_bwd_delta", g, out)
    b, n, hd = g.shape
    if tuple(out.shape) != (b, n, hd) or hd % num_heads:
        raise ValueError(f"qkv_attention_bwd_delta: g {tuple(g.shape)} and out "
                         f"{tuple(out.shape)} for {num_heads} heads")
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=g.device)
    code = _lib().qkv_attention_bwd_delta(g.data_ptr(), out.data_ptr(), delta.data_ptr(),
                                          b, n, num_heads, hd // num_heads, _cuda.stream())
    _cuda.check(code, "qkv_attention_bwd_delta")
    BWD_DELTA.add()
    return delta


def attention_bwd_dkv_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the dK/dV kernel: writes the k and v columns of ``dqkv``."""
    _cuda.require_cuda("qkv_attention_bwd_dkv", qkv, g, lse, delta, dqkv)
    b, n, d = _check_bwd_args("qkv_attention_bwd_dkv", qkv, g, lse, num_heads)
    if delta.shape != lse.shape or dqkv.shape != qkv.shape:
        raise ValueError("qkv_attention_bwd_dkv: delta/dqkv shapes do not match lse/qkv")
    mask, mask_ptr = mask_arg("qkv_attention_bwd_dkv", mask, n, qkv.device)
    code = _bwd_lib().qkv_attention_bwd_dkv(qkv.data_ptr(), g.data_ptr(), lse.data_ptr(),
                                        delta.data_ptr(), mask_ptr, dqkv.data_ptr(), b, n,
                                        num_heads, d, float(scale), _cuda.stream())
    _cuda.check(code, "qkv_attention_bwd_dkv")
    BWD_DKV.add()
    return dqkv


def attention_bwd_dq_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the dQ kernel: writes the q columns of ``dqkv``."""
    _cuda.require_cuda("qkv_attention_bwd_dq", qkv, g, lse, delta, dqkv)
    b, n, d = _check_bwd_args("qkv_attention_bwd_dq", qkv, g, lse, num_heads)
    if delta.shape != lse.shape or dqkv.shape != qkv.shape:
        raise ValueError("qkv_attention_bwd_dq: delta/dqkv shapes do not match lse/qkv")
    mask, mask_ptr = mask_arg("qkv_attention_bwd_dq", mask, n, qkv.device)
    code = _bwd_lib().qkv_attention_bwd_dq(qkv.data_ptr(), g.data_ptr(), lse.data_ptr(),
                                       delta.data_ptr(), mask_ptr, dqkv.data_ptr(), b, n,
                                       num_heads, d, float(scale), _cuda.stream())
    _cuda.check(code, "qkv_attention_bwd_dq")
    BWD_DQ.add()
    return dqkv


def attention_bwd_kernel(qkv, g, out, lse, num_heads, scale, mask=None):
    """dqkv through the three backward kernels."""
    delta = attention_bwd_delta_kernel(g, out, num_heads)
    dqkv = torch.empty_like(qkv)
    attention_bwd_dkv_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)
    return attention_bwd_dq_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)


def attention_fwd_bf16_kernel(qkv, num_heads, scale, mask=None):
    """Launch the bf16 arm's forward on a bf16 panel: (context (B, N, H*D)
    bf16, lse (B, H, N) f32)."""
    name = "qkv_attention_fwd_bf16"
    _cuda.require_cuda(name, qkv, dtype=torch.bfloat16)
    b, n, d = check_kernel_args(name, qkv, num_heads)
    mask, mask_ptr = mask_arg(name, mask, n, qkv.device)
    out = torch.empty((b, n, num_heads * d), dtype=torch.bfloat16, device=qkv.device)
    lse = torch.empty((b, num_heads, n), dtype=torch.float32, device=qkv.device)
    code = _bf16_lib().qkv_attention_fwd_bf16(qkv.data_ptr(), mask_ptr, out.data_ptr(),
                                              lse.data_ptr(), b, n, num_heads, d, float(scale),
                                              _cuda.stream())
    _cuda.check(code, name)
    FWD_BF16.add()
    return out, lse


def attention_bwd_delta_bf16_kernel(g, out, num_heads):
    """Launch the bf16 arm's delta pre-pass on bf16 g and context:
    rowsum(dO * O) in f32, (B, H, N) f32."""
    name = "qkv_attention_bwd_delta_bf16"
    _cuda.require_cuda(name, g, out, dtype=torch.bfloat16)
    b, n, hd = g.shape
    if tuple(out.shape) != (b, n, hd) or hd % num_heads:
        raise ValueError(f"{name}: g {tuple(g.shape)} and out {tuple(out.shape)} for "
                         f"{num_heads} heads")
    delta = torch.empty((b, num_heads, n), dtype=torch.float32, device=g.device)
    code = _bf16_lib().qkv_attention_bwd_delta_bf16(g.data_ptr(), out.data_ptr(),
                                                    delta.data_ptr(), b, n, num_heads,
                                                    hd // num_heads, _cuda.stream())
    _cuda.check(code, name)
    BWD_DELTA_BF16.add()
    return delta


def _bwd_bf16(name, counter, qkv, g, lse, delta, num_heads, scale, dqkv, mask):
    _cuda.require_cuda(name, qkv, g, dqkv, dtype=torch.bfloat16)
    _cuda.require_cuda(name, lse, delta)
    if qkv.device != lse.device:
        raise ValueError(f"{name}: lse is on {lse.device}, qkv on {qkv.device}")
    b, n, d = _check_bwd_args(name, qkv, g, lse, num_heads)
    if delta.shape != lse.shape or dqkv.shape != qkv.shape:
        raise ValueError(f"{name}: delta/dqkv shapes do not match lse/qkv")
    mask, mask_ptr = mask_arg(name, mask, n, qkv.device)
    code = getattr(_bf16_lib(), name)(qkv.data_ptr(), g.data_ptr(), lse.data_ptr(),
                                      delta.data_ptr(), mask_ptr, dqkv.data_ptr(), b, n,
                                      num_heads, d, float(scale), _cuda.stream())
    _cuda.check(code, name)
    counter.add()
    return dqkv


def attention_bwd_dkv_bf16_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the bf16 arm's dK/dV pass: writes the k and v columns of the
    bf16 ``dqkv``."""
    return _bwd_bf16("qkv_attention_bwd_dkv_bf16", BWD_DKV_BF16, qkv, g, lse, delta, num_heads,
                     scale, dqkv, mask)


def attention_bwd_dq_bf16_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask=None):
    """Launch the bf16 arm's dQ pass: writes the q columns of the bf16
    ``dqkv``."""
    return _bwd_bf16("qkv_attention_bwd_dq_bf16", BWD_DQ_BF16, qkv, g, lse, delta, num_heads,
                     scale, dqkv, mask)


def attention_bwd_bf16_kernel(qkv, g, out, lse, num_heads, scale, mask=None):
    """The bf16 dqkv through the bf16 arm's three backward kernels."""
    delta = attention_bwd_delta_bf16_kernel(g, out, num_heads)
    dqkv = torch.empty_like(qkv)
    attention_bwd_dkv_bf16_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)
    return attention_bwd_dq_bf16_kernel(qkv, g, lse, delta, num_heads, scale, dqkv, mask)


def _forward(qkv, num_heads, scale, mask):
    """(context, lse): the plain version on a CPU tensor, else the arm of
    qkv's dtype."""
    _check_dtype("fused_qkv_attention", qkv)
    if qkv.device.type == "cpu":
        return attention_fwd_plain(qkv, num_heads, scale, mask)
    if qkv.dtype == torch.bfloat16:
        return attention_fwd_bf16_kernel(qkv, num_heads, scale, mask)
    return attention_fwd_kernel(qkv, num_heads, scale, mask)


class _FusedQKVAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale, mask):
        out, lse = _forward(qkv, num_heads, scale, mask)
        ctx.save_for_backward(qkv, out, lse)
        ctx.num_heads, ctx.scale, ctx.mask = num_heads, scale, mask
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        g = g.contiguous().to(qkv.dtype)
        if qkv.device.type == "cpu":
            dqkv = attention_bwd_plain(qkv, g, lse, ctx.num_heads, ctx.scale, ctx.mask)
        elif qkv.dtype == torch.bfloat16:
            dqkv = attention_bwd_bf16_kernel(qkv, g, out, lse, ctx.num_heads, ctx.scale,
                                             ctx.mask)
        else:
            dqkv = attention_bwd_kernel(qkv, g, out, lse, ctx.num_heads, ctx.scale, ctx.mask)
        return dqkv, None, None, None


def fused_qkv_attention(qkv, num_heads, mask=None, scale=None):
    """Merged (B, N, H*D) context in qkv's dtype (float32 or bfloat16) from
    the native (B, N, 3*H*D) qkv panel, differentiable. ``mask``: optional
    shared (N, N) bool on qkv's device, True = attend; ``scale`` overrides
    1/sqrt(D)."""
    _, n, d = _dims(qkv, num_heads)
    traced = _cuda.tracing() and not (torch.is_grad_enabled() and qkv.requires_grad)
    if mask is not None:
        if mask.ndim != 2:
            raise ValueError("fused_qkv_attention supports a shared (N, N) mask")
        if not traced:
            mask_arg("fused_qkv_attention", mask, n, qkv.device)
    scale = d ** -0.5 if scale is None else float(scale)
    if traced:  # a traced forward without gradients records the forward's op
        return torch.ops.vit4hep.qkv_attention_fwd(qkv.contiguous(), num_heads, scale, mask)[0]
    return _FusedQKVAttention.apply(qkv.contiguous(), num_heads, scale, mask)


@torch.library.custom_op(
    "vit4hep::qkv_attention_fwd", mutates_args=(),
    schema="(Tensor qkv, int num_heads, float scale, Tensor? mask) -> (Tensor, Tensor)")
def qkv_attention_fwd_op(qkv, num_heads, scale, mask):
    """The forward as a registered op (what a traced
    :func:`fused_qkv_attention` records without gradients): (context, lse)
    of the plain version on CPU tensors, of the kernel of qkv's dtype
    (counted) on CUDA tensors."""
    return _forward(qkv, num_heads, scale, mask)


@qkv_attention_fwd_op.register_fake
def _(qkv, num_heads, scale, mask):
    b, n, width = qkv.shape
    return (qkv.new_empty((b, n, width // 3)),
            qkv.new_empty((b, num_heads, n), dtype=torch.float32))
