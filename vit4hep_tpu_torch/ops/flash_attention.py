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
``csrc/flash_attention.cu`` or raises, each with its own launch counter:
the pre-pass (``split_kernel``), which writes the operands' tf32 hi and lo
parts into padded contiguous buffers in the layouts the tensor cores read
(``split_plain`` is its plain version), then the forward, or the dK/dV
and dQ passes, each product as three TF32 products (split TF32: the f32
contract on the tensor cores). The forward splits K and V, the backward
Q, dO, K and V once for both of its passes. q, k and v may be strided
views with one stride set and a unit column stride (the ViT's split of its
qkv panel), which the pre-pass and the forward read in place; the
upstream gradient has its own strides. Outputs are contiguous
(B, H, N, D) f32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.ops import _cuda
from vit4hep_tpu_torch.ops.fused_qkv_attention import mask_arg
from vit4hep_tpu_torch.ops.vmem_attention import check_shapes, kernel_qkv_args, kernel_strides

_NEG_INF = -1e30
_P, _I, _F = _cuda.P, _cuda.I, _cuda.F
_STRIDES = [_cuda.LL] * 3
_DIMS = [_I, _I, _I, _I, _F, _P]  # B, H, n, d, scale, stream
_SIGNATURES = {
    "flash_attention_split": [_P, _I, _I, _I, _I, _I, _P],
    "flash_attention_fwd": [_P, *_STRIDES, _P, _P, _P, _P, _P, _P, _P, *_DIMS],
    "flash_attention_bwd_dkv": [_P, _P, _P, _P, _P, _P, *_DIMS],
    "flash_attention_bwd_dq": [_P, _P, _P, _P, _P, *_DIMS],
}

SPLIT = _cuda.LaunchCounter("flash_attn_split")
FWD = _cuda.LaunchCounter("flash_attn_fwd")
BWD_DKV = _cuda.LaunchCounter("flash_attn_bwd_dkv")
BWD_DQ = _cuda.LaunchCounter("flash_attn_bwd_dq")

PAD = 64  # the split buffers' rows: N rounded up to PAD (csrc/flash_tf32.cuh)
ROWS, COLS = "rows", "cols"  # the two layouts of a split operand
# the cols layout holds the 8 rows of each chunk in this order
CHUNK_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# the backward's split operands in k7::BwdOps's field order, each with the
# passes that read it (BwdOps below is built from this table alone)
_BOTH = ("dq", "dkv")
BWD_OPS = {("q", ROWS): _BOTH, ("g", ROWS): _BOTH, ("k", ROWS): _BOTH, ("v", ROWS): _BOTH,
           ("q", COLS): ("dkv",), ("g", COLS): ("dkv",), ("k", COLS): ("dq",)}


def bwd_field(op, part):
    """k7::BwdOps's field for one split buffer: q_hi, g_lo, ..., qt_hi (the
    cols layout with a t)."""
    nm, lay = op
    return f"{nm}{'t' if lay == COLS else ''}_{part}"


class BwdOps(ctypes.Structure):
    """k7::BwdOps (csrc/flash_tf32.cuh), field by field: each split
    operand's hi and lo buffers, 0 where the pass reads none."""
    _fields_ = [(bwd_field(op, part), ctypes.c_void_p) for op in BWD_OPS for part in ("hi", "lo")]


def _needs(passes):
    """The split operands that ``passes`` read."""
    return {op for op, readers in BWD_OPS.items() if set(readers) & set(passes)}


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


def padded(n):
    """N rounded up to the split buffers' PAD rows."""
    return -(-n // PAD) * PAD


def padded_dim(d):
    """The kernels' padded head dim DP = 16 ceil(d / 16)."""
    return 16 * -(-d // 16)


def tf32_plain(x):
    """x rounded to the nearest tf32, ties away from zero (cvt.rna.tf32.f32):
    the low 13 mantissa bits rounded into the rest."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _swizzle(t):
    """The 32-byte swizzle of (..., row / 4 % 2, row % 4, half, 4) tiles:
    the two 16-byte halves of a row swapped where row / 4 is odd."""
    return torch.cat([t[..., :1, :, :, :], t[..., 1:, :, :, :].flip(-2)], dim=-4)


def layout_plain(x, layout):
    """A padded (B, H, N_pad, DP) f32 tensor in a split buffer's layout (the
    (B, H, N_pad, DP) storage read in that order): ROWS, 8-row group g,
    8-column chunk c, row r at float g DP 8 + c 64 + r 8; COLS, 8-row chunk
    k, column e at float k DP 8 + e 8, its rows in CHUNK_ORDER; each row of
    8 values with the 32-byte swizzle."""
    b, h, n_pad, dp = x.shape
    if layout == ROWS:  # (g, r, c, j) -> (g, c, r, j)
        t = x.reshape(b, h, n_pad // 8, 8, dp // 8, 8).permute(0, 1, 2, 4, 3, 5)
    else:  # (k, row, e) -> (k, e, row in CHUNK_ORDER)
        t = x.reshape(b, h, n_pad // 8, 8, dp)[:, :, :, list(CHUNK_ORDER)].transpose(3, 4)
        t = t.reshape(b, h, n_pad // 8, dp // 8, 8, 8)
    t = t.reshape(*t.shape[:4], 2, 4, 2, 4)
    return _swizzle(t).reshape(b, h, n_pad, dp)


def split_plain(x, layout):
    """``split_kernel``'s buffers for one operand and layout: (hi, lo) of x
    (B, H, N, D) zero-padded to (N_pad, DP), hi = tf32(x), lo = tf32(x - hi),
    each in ``layout_plain``'s order."""
    b, h, n, d = x.shape
    xp = x.new_zeros((b, h, padded(n), padded_dim(d)), dtype=torch.float32)
    xp[..., :n, :d] = x
    hi = tf32_plain(xp)
    return layout_plain(hi, layout), layout_plain(tf32_plain(xp - hi), layout)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------
def split_kernel(name, operands, b, h, n, d):
    """Launch the pre-pass once for up to four operands: ``operands`` a
    list of (x, layouts), x (B, H, N, D) f32 with a unit column stride;
    returns per operand {layout: (hi, lo)}, each buffer (B, H, N_pad, DP)
    f32 in ``layout_plain``'s order."""
    shape = (b, h, padded(n), padded_dim(d))
    vals, outs = [], []
    for x, layouts in operands:
        strides = kernel_strides(name, x)
        bufs = {lay: tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                           for _ in range(2)) for lay in layouts}
        vals += [x.data_ptr(), *strides,
                 *(bufs[lay][i].data_ptr() if lay in bufs else 0
                   for lay in (ROWS, COLS) for i in range(2))]
        outs.append(bufs)
    jobs = (ctypes.c_longlong * len(vals))(*vals)
    code = _lib().flash_attention_split(ctypes.addressof(jobs), len(operands), b, h, n, d,
                                        _cuda.stream())
    _cuda.check(code, "flash_attention_split")
    SPLIT.add()
    return outs


def flash_fwd_kernel(q, k, v, scale, mask=None, kv=None):
    """Launch the forward kernel: (out (B, H, N, D) f32, lse (B, H, N) f32);
    ``kv`` the pre-pass's K (rows) and V (cols) buffers, split here when
    not given."""
    b, h, n, d, strides, mask, mask_ptr = kernel_qkv_args("flash_attention_fwd", q, k, v, mask)
    if kv is None:
        kv = split_kernel("flash_attention_fwd", [(k, (ROWS,)), (v, (COLS,))], b, h, n, d)
    kr, vc = kv
    out = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    code = _lib().flash_attention_fwd(q.data_ptr(), *strides,
                                      *(t.data_ptr() for t in (*kr[ROWS], *vc[COLS])), mask_ptr,
                                      out.data_ptr(), lse.data_ptr(), b, h, n, d, float(scale),
                                      _cuda.stream())
    _cuda.check(code, "flash_attention_fwd")
    FWD.add()
    return out, lse


def split_bwd(q, k, v, g, passes=("dq", "dkv")):
    """The backward's split operands for ``passes``, in one pre-pass launch:
    {(tensor name, layout): (hi, lo)}."""
    b, h, n, d = q.shape
    need = _needs(passes)
    names = [nm for nm in ("q", "g", "k", "v") if any(op[0] == nm for op in need)]
    tensors = {"q": q, "k": k, "v": v, "g": g}
    outs = split_kernel("flash_attention_bwd", [
        (tensors[nm], tuple(lay for lay in (ROWS, COLS) if (nm, lay) in need)) for nm in names],
        b, h, n, d)
    return {(nm, lay): bufs for nm, out in zip(names, outs) for lay, bufs in out.items()}


def _ops_struct(ops, passes):
    """k7::BwdOps filled by name from ``ops`` with the buffers ``passes``
    read; raises if one of them is missing."""
    need = _needs(passes)
    if not need <= set(ops):
        raise ValueError(f"flash_attention: split operands {sorted(need - set(ops))} missing")
    return BwdOps(**{bwd_field(op, part): t.data_ptr()
                     for op in need for part, t in zip(("hi", "lo"), ops[op])})


def _bwd_args(name, q, k, v, g, lse, delta, mask):
    b, h, n, d, _, mask, mask_ptr = kernel_qkv_args(name, q, k, v, mask)
    if tuple(g.shape) != (b, h, n, d) or tuple(lse.shape) != (b, h, n) or \
            tuple(delta.shape) != (b, h, n):
        raise ValueError(f"{name}: g {tuple(g.shape)} / lse {tuple(lse.shape)} / delta "
                         f"{tuple(delta.shape)} do not match q {tuple(q.shape)}")
    _cuda.require_cuda(name, lse, delta)
    kernel_strides(name, g)
    return b, h, n, d, mask, mask_ptr


def flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask=None, ops=None):
    """Launch the dK/dV pass: (dk, dv) (B, H, N, D) f32; ``ops`` the split
    operands (``split_bwd``), split here when not given."""
    name = "flash_attention_bwd_dkv"
    b, h, n, d, mask, mask_ptr = _bwd_args(name, q, k, v, g, lse, delta, mask)
    ops = split_bwd(q, k, v, g, ("dkv",)) if ops is None else ops
    x = _ops_struct(ops, ("dkv",))
    lse_p = F.pad(lse, (0, padded(n) - n), value=float("inf"))  # p = 0 past n
    delta_p = F.pad(delta, (0, padded(n) - n))
    dk = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    code = _lib().flash_attention_bwd_dkv(ctypes.byref(x), lse_p.data_ptr(),
                                          delta_p.data_ptr(), mask_ptr, dk.data_ptr(),
                                          dv.data_ptr(), b, h, n, d, float(scale),
                                          _cuda.stream())
    _cuda.check(code, name)
    BWD_DKV.add()
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask=None, ops=None):
    """Launch the dQ pass: dq (B, H, N, D) f32; ``ops`` as for the dK/dV
    pass."""
    name = "flash_attention_bwd_dq"
    b, h, n, d, mask, mask_ptr = _bwd_args(name, q, k, v, g, lse, delta, mask)
    ops = split_bwd(q, k, v, g, ("dq",)) if ops is None else ops
    x = _ops_struct(ops, ("dq",))
    dq = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    code = _lib().flash_attention_bwd_dq(ctypes.byref(x), lse.data_ptr(), delta.data_ptr(),
                                         mask_ptr, dq.data_ptr(), b, h, n, d, float(scale),
                                         _cuda.stream())
    _cuda.check(code, name)
    BWD_DQ.add()
    return dq


def flash_bwd_kernel(q, k, v, g, out, lse, scale, mask=None):
    """(dq, dk, dv) through delta, one pre-pass and the two backward
    kernels; the dK/dV pass's own operands are freed before the dQ pass."""
    delta = delta_plain(g, out)
    ops = split_bwd(q, k, v, g)
    dk, dv = flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask, ops)
    for op in set(ops) - _needs(("dq",)):
        del ops[op]
    return flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask, ops), dk, dv


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
    kernel's blocks, accepted for its signature: the CUDA kernels keep 64
    rows a warpgroup and stream 32 (or 16) rows a tile, and the function
    does not depend on the blocking. bf16 q, k, v run the f32 arm on their
    values and the result is rounded to bf16: JAX's kernel casts its
    operands to f32 and stores in the input's dtype."""
    if q.dtype == torch.bfloat16:
        return flash_attention(q.float(), k.float(), v.float(), mask,
                               scale=scale).to(torch.bfloat16)
    del block_q, block_k
    _, _, n, d = check_shapes("flash_attention", q, k, v, mask)
    if mask is not None:
        mask_arg("flash_attention", mask, n, q.device)
    scale = d ** -0.5 if scale is None else float(scale)
    if q.device.type != "cpu" and not (q.stride() == k.stride() == v.stride()
                                       and q.stride(3) == 1):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, scale, mask)
