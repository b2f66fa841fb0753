"""Energy-transformer decoder: 4 post-LN decoder layers + final LayerNorm +
2-layer head (port of ``vit4hep_tpu/ops/fused_energy_decoder.py``).

:func:`fused_energy_decoder` takes the JAX function's arguments, with the
weights in its Dense layout ``(in, out)``. On CPU tensors it runs
:func:`_reference`, the plain PyTorch version. On CUDA tensors it launches
a hand-written kernel of ``csrc/energy_decoder.cu`` or raises; there is no
fallback between the two. At the widths of every shipped energy config
(:func:`tensor_core_shape`: d_model 128 in 4 heads of 32, feed-forward and
head widths multiples of 64, at most 64 tokens) that is
``energy_decoder_tf32_kernel``, every product on the tensor cores in split
TF32 (three TF32 products each, the f32 contract), two elements a CTA;
at any other width the f32 CUDA-core ``energy_decoder_kernel``, one CTA per
element. Both take the weights as JAX stores them. With gradients enabled and
an input requiring them it is a ``torch.autograd.Function`` whose forward
is that kernel and whose backward is the VJP of the plain version, as
JAX's ``_bwd`` takes the VJP of its composed reference.

The cross-attention enters as a per-layer bias: with a one-token encoder
memory, softmax over one key is 1 and the cross-attention output is
``out_proj(v_proj(memory))`` for every query (the caller computes it). The
TPU kernel grouped ``group`` batch elements into one block-diagonal score
matmul to feed its matrix unit; per-element attention is exact without it,
so ``group`` is accepted and does not change the CUDA kernel's work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit4hep_tpu_torch.ops import _cuda

_LN_EPS = 1e-5
_ACTS = {"relu": 1, "gelu": 2, "silu": 3}
_SIGNATURES = {
    name: [_cuda.P] * 20 + [_cuda.I] * 9 + [_cuda.F, _cuda.P]
    for name in ("energy_decoder_forward", "energy_decoder_tf32_forward")
}

ENERGY_DECODER = _cuda.LaunchCounter("energy_decoder")


def _act(name):
    return {"relu": F.relu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "silu": F.silu}[name]


def _ln_affine(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + _LN_EPS) * scale + bias


def _reference(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2,
               b2, fs, fb, hw0, hb0, hw1, hb1, num_heads, activation):
    """Plain PyTorch version (f32): the CPU path and the kernel's oracle."""
    b, n, dm = tgt.shape
    d = dm // num_heads
    scale = float(d) ** -0.5
    act = _act(activation)
    x = tgt.float()
    for li in range(wqkv.shape[0]):
        qkv = x @ wqkv[li] + bqkv[li]
        q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)
        s = (q @ k.transpose(-1, -2)) * scale
        p = torch.exp(s - s.amax(-1, keepdim=True))
        ctx = (p @ v) / p.sum(-1, keepdim=True)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, n, dm)
        x = _ln_affine(x + (ctx @ wo[li] + bo[li]), ln_s[li, 0], ln_b[li, 0])
        x = _ln_affine(x + cross[:, li, None, :], ln_s[li, 1], ln_b[li, 1])
        y = act(x @ w1[li] + b1[li]) @ w2[li] + b2[li]
        x = _ln_affine(x + y, ln_s[li, 2], ln_b[li, 2])
    x = _ln_affine(x, fs, fb)
    hcat = torch.cat([tf.float()[:, None, :].expand(b, n, tf.shape[1]), x], dim=-1)
    hid = F.silu(hcat @ hw0 + hb0)
    return (hid @ hw1 + hb1)[..., 0]


def smem_bytes(n, dm, fdim, hdim0, num_heads):
    """Shared memory the f32 CUDA-core kernel needs per element
    (energy_decoder.cu)."""
    buf = max(n * (3 * dm + 1), n * fdim, n * hdim0)
    return 4 * (2 * n * dm + buf + max(num_heads * n * n, hdim0) + num_heads * n)


def tc_smem_bytes(n, hdim0, depth, fdim):
    """Shared memory of the tensor-core kernel's CTA (energy_decoder.cu,
    ``tc::smem_bytes``): the hi and lo B operands of two weight units (2 x
    2 x 4096 tf32), each of its two warpgroups' k and v^T tiles (4 x 128
    bytes a padded key), the activations (64 values x 256 threads), the
    head's time-feature vectors, the table of weight units (16 bytes each)
    and the alignment slack."""
    nk = -(-n // 16) * 16
    units = depth * (20 + fdim // 16) + hdim0 // 32
    return (4 * 4096 * 4 + 2 * 4 * nk * 128 + 64 * 256 * 4 + 2 * hdim0 * 4 + 16 * units
            + 1024)


def tensor_core_shape(n, dm, num_heads, fdim, hdim0, depth):
    """Whether the tensor-core kernel takes this shape: d_model 128 in 4
    heads of 32, feed-forward and head widths multiples of 64, 1 to 64
    tokens, within the card's shared memory. Every shipped energy config
    does (45, 7, 5, 3 and 58 tokens, 4 layers)."""
    return (dm == 128 and num_heads == 4 and 1 <= n <= 64 and fdim >= 64 and fdim % 64 == 0
            and hdim0 >= 64 and hdim0 % 64 == 0
            and tc_smem_bytes(n, hdim0, depth, fdim) <= _cuda.MAX_SMEM_BYTES)


def fused_energy_decoder(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo,
                         w1, b1, w2, b2, fs, fb, hw0, hb0, hw1, hb1,
                         num_heads, activation="relu", group=16):
    """Decoder stack + head. tgt (B, N, D) embedded target; tf (B, TE) time
    features; cross (B, L, D) per-layer cross-attention outputs; ln_s/ln_b
    (L, 3, D) LayerNorm scales/biases (after self-attn, after cross-attn,
    after FFN); fs/fb the final LayerNorm; hw0 (TE + D, HN), hb0, hw1
    (HN, 1), hb1 the velocity head on [tf, h]. Returns (B, N) velocities."""
    args = (tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2,
            fs, fb, hw0, hb0, hw1, hb1)
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return _FusedEnergyDecoder.apply(num_heads, activation, *args)
    if _cuda.tracing():
        return torch.ops.vit4hep.energy_decoder(*args, num_heads, activation)
    return _forward(*args, num_heads=num_heads, activation=activation)


def _forward(*args, num_heads, activation):
    if args[0].device.type == "cpu":
        return _reference(*args, num_heads=num_heads, activation=activation)
    return energy_decoder_kernel(*args, num_heads=num_heads, activation=activation)


class _FusedEnergyDecoder(torch.autograd.Function):
    """The kernel forward; the backward is the VJP of :func:`_reference`."""

    @staticmethod
    def forward(ctx, num_heads, activation, *args):
        ctx.save_for_backward(*args)
        ctx.num_heads, ctx.activation = num_heads, activation
        return _forward(*args, num_heads=num_heads, activation=activation)

    @staticmethod
    def backward(ctx, g):
        args = [a.detach().requires_grad_() for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = _reference(*args, num_heads=ctx.num_heads, activation=ctx.activation)
        return (None, None, *torch.autograd.grad(out, args, g, allow_unused=True))


def energy_decoder_kernel(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo,
                          w1, b1, w2, b2, fs, fb, hw0, hb0, hw1, hb1,
                          num_heads, activation):
    """Launch a kernel of ``csrc/energy_decoder.cu`` on the current stream:
    the tensor-core kernel where :func:`tensor_core_shape` holds, else the
    f32 CUDA-core kernel."""
    b, n, dm = tgt.shape
    depth, fdim = w1.shape[0], w1.shape[-1]
    te, hdim0 = tf.shape[1], hw0.shape[1]
    args = [a.contiguous() for a in (tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo,
                                     w1, b1, w2, b2, fs, fb, hw0, hb0, hw1, hb1)]
    _cuda.require_cuda("fused_energy_decoder", *args)
    expect = [(b, n, dm), (b, te), (b, depth, dm), (depth, 3, dm), (depth, 3, dm),
              (depth, dm, 3 * dm), (depth, 3 * dm), (depth, dm, dm), (depth, dm),
              (depth, dm, fdim), (depth, fdim), (depth, fdim, dm), (depth, dm),
              (dm,), (dm,), (te + dm, hdim0), (hdim0,), (hdim0, 1), (1,)]
    for i, (a, shape) in enumerate(zip(args, expect)):
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_energy_decoder: argument {i} has shape "
                             f"{tuple(a.shape)}, expected {shape}")
    if activation not in _ACTS:
        raise ValueError(f"fused_energy_decoder: activation '{activation}' not supported")
    if dm % num_heads:
        raise ValueError(f"fused_energy_decoder: d_model {dm} not divisible by {num_heads} heads")
    tensor_cores = tensor_core_shape(n, dm, num_heads, fdim, hdim0, depth)
    need = smem_bytes(n, dm, fdim, hdim0, num_heads)
    if not tensor_cores and need > _cuda.MAX_SMEM_BYTES:
        raise ValueError(f"fused_energy_decoder: {need} bytes of shared memory needed per "
                         f"element, above the card's {_cuda.MAX_SMEM_BYTES}")
    out = torch.empty((b, n), dtype=torch.float32, device=tgt.device)
    lib = _cuda.load("energy_decoder", _SIGNATURES)
    launch = lib.energy_decoder_tf32_forward if tensor_cores else lib.energy_decoder_forward
    code = launch(
        *[a.data_ptr() for a in args], out.data_ptr(),
        b, n, dm, te, fdim, hdim0, depth, num_heads, _ACTS[activation],
        float(dm // num_heads) ** -0.5, _cuda.stream())
    _cuda.check(code, "energy_decoder")
    ENERGY_DECODER.add()
    return out



@torch.library.custom_op(
    "vit4hep::energy_decoder", mutates_args=(),
    schema="(Tensor tgt, Tensor tf, Tensor cross, Tensor ln_s, Tensor ln_b, Tensor wqkv, "
           "Tensor bqkv, Tensor wo, Tensor bo, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
           "Tensor fs, Tensor fb, Tensor hw0, Tensor hb0, Tensor hw1, Tensor hb1, "
           "int num_heads, str activation) -> Tensor")
def energy_decoder_op(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2, fs, fb,
                      hw0, hb0, hw1, hb1, num_heads, activation):
    """The forward as a registered op (what a traced
    :func:`fused_energy_decoder` records): the plain version on CPU tensors,
    the kernel (counted) on CUDA tensors."""
    return _forward(tgt, tf, cross, ln_s, ln_b, wqkv, bqkv, wo, bo, w1, b1, w2, b2, fs, fb, hw0,
                    hb0, hw1, hb1, num_heads=num_heads, activation=activation)


@energy_decoder_op.register_fake
def _(tgt, *_args):
    return tgt.new_empty(tgt.shape[:2], dtype=torch.float32)
