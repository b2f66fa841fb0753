"""Port parity of the native-layout attention (kernel K1, forward and
backward) and of the attention dispatch, against the JAX package.

CPU tests: the same numpy qkv panel goes through JAX ``fused_qkv_attention``
(its Pallas kernels in interpret mode, f32, as tests/test_attention.py runs
them) and the port's ``fused_qkv_attention`` (its plain versions through the
``autograd.Function``). The context, the per-head log-sum-exp and the
gradient of sum(out^2) are compared, unmasked and with a shared (N, N)
mask: the layer-causal mask of a (2, 2, 3) token grid, and a mask with one
wholly masked row (whose context is the mean of V). Tolerances: forward
atol 2e-5 (f32 on both sides, summation order only, as
tests/test_attention.py holds the JAX kernel to XLA); gradients atol 1e-4
(the 5-product backward adds two more f32 reductions over N).

CUDA tests (marker ``cuda``) hold each hand-written kernel against its plain
version on the card; they skip without one. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.ops import fused_qkv_attention as jfqa
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import attention as tattn
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _qkv(rng, b, n, h, d, std=1.0):
    return (rng.normal(size=(b, n, 3 * h * d)) * std).astype(np.float32)


# (B, N, H, d): d = 80 is the ds2 per-head path, d = 48 the TPU's head-packed
# body (d <= 64); N is not a multiple of 8
CPU_SHAPES = [(2, 13, 2, 80), (2, 19, 3, 48)]


@pytest.mark.parametrize("b,n,h,d", CPU_SHAPES, ids=["d80", "d48-packed"])
def test_fused_qkv_attention_matches_jax_interpret(b, n, h, d):
    qkv = _qkv(np.random.default_rng(30), b, n, h, d)
    out_j, (_, _, lse_j) = jfqa._fused_fwd(jnp.asarray(qkv), h, None)
    grad_j = jax.grad(lambda x: jnp.sum(jfqa.fused_qkv_attention(x, h) ** 2))(jnp.asarray(qkv))

    x = torch.from_numpy(qkv).requires_grad_()
    out = tfqa.fused_qkv_attention(x, h)
    (grad,) = torch.autograd.grad((out ** 2).sum(), x)
    _, lse = tfqa.attention_fwd_plain(torch.from_numpy(qkv), h, d ** -0.5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=1e-4)


def test_fused_qkv_attention_masked_matches_jax_interpret():
    """The shared (N, N) mask runs on the CPU (the masked kernels are not ported)."""
    b, n, h, d = 2, 21, 2, 16
    qkv = _qkv(np.random.default_rng(31), b, n, h, d)
    mask = np.tril(np.ones((n, n), bool))
    grad_j = jax.grad(lambda x: jnp.sum(jfqa.fused_qkv_attention(x, h, jnp.asarray(mask)) ** 2))(
        jnp.asarray(qkv))
    out_j = jfqa.fused_qkv_attention(jnp.asarray(qkv), h, jnp.asarray(mask))
    x = torch.from_numpy(qkv).requires_grad_()
    out = tfqa.fused_qkv_attention(x, h, torch.from_numpy(mask))
    (grad,) = torch.autograd.grad((out ** 2).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=1e-4)


def _one_dead_row(n, row=3):
    """A causal mask whose row ``row`` attends to no key."""
    mask = np.tril(np.ones((n, n), bool))
    mask[row] = False
    return mask


MASKS = {"layer_causal": lambda n: layer_causal_mask((2, 2, 3)), "dead_row": _one_dead_row}


# d = 80 takes the TPU's per-head body (_fused_kernel_masked), d = 16 its
# head-packed body (_packed_kernel_masked, d <= 64); N = 12 tokens
@pytest.mark.parametrize("d", [80, 16], ids=["per_head-d80", "packed-d16"])
@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_masked_fused_qkv_attention_matches_jax_interpret(d, mask_name):
    b, n, h = 2, 12, 2
    qkv = _qkv(np.random.default_rng(37), b, n, h, d)
    mask = MASKS[mask_name](n)
    jmask = jnp.asarray(mask)
    out_j, (_, _, lse_j) = jfqa._fused_fwd(jnp.asarray(qkv), h, jmask)
    grad_j = jax.grad(lambda x: jnp.sum(jfqa.fused_qkv_attention(x, h, jmask) ** 2))(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = tfqa.fused_qkv_attention(x, h, torch.from_numpy(mask))
    (grad,) = torch.autograd.grad((out ** 2).sum(), x)
    _, lse = tfqa.attention_fwd_plain(torch.from_numpy(qkv), h, d ** -0.5, torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=2e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=1e-4)
    if mask_name == "dead_row":  # the wholly masked row attends to every key equally
        v = qkv[..., 2 * h * d:].reshape(b, n, h, d)
        np.testing.assert_allclose(out.detach().numpy()[:, 3].reshape(b, h, d), v.mean(1),
                                   atol=2e-5)


def test_mask_is_validated():
    """The mask must be a bool (N, N) on qkv's device."""
    qkv = torch.zeros(1, 12, 3 * 2 * 8)
    for bad in (torch.ones(12, 12), torch.ones(12, 11, dtype=torch.bool),
                torch.ones(12, 12, dtype=torch.bool, device="meta")):
        with pytest.raises(ValueError, match="mask"):
            tfqa.fused_qkv_attention(qkv, 2, bad)
    with pytest.raises(ValueError, match="shared"):
        tfqa.fused_qkv_attention(qkv, 2, torch.ones(1, 12, 12, dtype=torch.bool))


def test_plain_backward_is_the_vjp_of_plain_forward():
    """attention_bwd_plain (from the lse, as the kernels do) equals autograd
    through the plain forward, with a scale override."""
    b, n, h, d = 3, 17, 2, 12
    qkv = torch.from_numpy(_qkv(np.random.default_rng(32), b, n, h, d)).requires_grad_()
    g = torch.from_numpy(np.random.default_rng(33).normal(size=(b, n, h * d)).astype(np.float32))
    out, lse = tfqa.attention_fwd_plain(qkv, h, 0.3)
    (want,) = torch.autograd.grad(out, qkv, g)
    got = tfqa.attention_bwd_plain(qkv.detach(), g, lse.detach(), h, 0.3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    delta = tfqa.delta_plain(g, out.detach(), h)
    assert delta.shape == (b, h, n)


def test_dispatch_routes_auto_by_length(monkeypatch):
    """auto: plain below 128 tokens, K1 from 128 while fused_fits; an explicit
    fused beyond the bound raises ValueError, as in JAX."""
    calls = []
    real = tattn.fused_qkv_attention

    def spy(*args, **kw):
        calls.append(args[0].shape[1])
        return real(*args, **kw)

    monkeypatch.setattr(tattn, "fused_qkv_attention", spy)
    rng = np.random.default_rng(34)
    for n in (127, 128, 135):
        qkv = torch.from_numpy(_qkv(rng, 1, n, 2, 8))
        out = tattn.qkv_attention(qkv, 2)
        plain = tattn.qkv_attention(qkv, 2, impl="xla")
        torch.testing.assert_close(out, plain, atol=2e-6, rtol=1e-5)
    assert calls == [128, 135]
    assert tattn.fused_fits(2048, 480, 6) and not tattn.fused_fits(2049, 480, 6)
    with pytest.raises(ValueError, match="fused"):
        tattn.qkv_attention(torch.zeros(1, 2049, 3 * 480, device="meta"), 6, impl="fused")


def test_unported_kernels_raise_on_the_card_and_run_plain_on_cpu():
    """Every attention kernel's wrapper takes a tensor off the CPU to its
    kernel, never to a plain version: K7 (the separated-layout flash kernel,
    ported since) for ``dot_product_attention(impl="flash")``, its ``auto``
    above 1024 tokens and ``qkv_attention``'s ``flash`` past
    ``flash_qkv_fits`` (10,752 tokens at hidden 480, 6 heads), and K6
    ``flash``, K8 ``vmem`` and masked K1: on the meta device each refuses
    the tensor. On a CPU tensor each runs its plain version."""
    sep = torch.zeros(1, 2, 300, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.dot_product_attention(sep, sep, sep, impl="flash")
    long = torch.zeros(1, 2, 1100, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):  # auto: flash (K7) above 1024
        tattn.dot_product_attention(long, long, long)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tattn.qkv_attention(torch.zeros(1, 10753, 3 * 480, device="meta"), 6, impl="flash")
    meta = torch.zeros(1, 300, 3 * 2 * 8, device="meta")
    for impl in ("flash", "vmem"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            tattn.qkv_attention(meta, 2, impl=impl)
    with pytest.raises(ValueError, match="CUDA tensor"):  # auto picks vmem (K8) at 300
        tattn.dot_product_attention(sep, sep, sep)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfqa.fused_qkv_attention(meta, 2, torch.ones(300, 300, dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tfqa.attention_fwd_kernel(torch.zeros(1, 300, 48), 2, 0.25)
    qkv = torch.from_numpy(_qkv(np.random.default_rng(35), 1, 300, 2, 8))
    ref = tattn.qkv_attention(qkv, 2, impl="xla")
    for impl in ("flash", "vmem"):
        torch.testing.assert_close(tattn.qkv_attention(qkv, 2, impl=impl), ref)
    q, k, v = qkv.reshape(1, 300, 3, 2, 8).permute(2, 0, 3, 1, 4).unbind(0)
    torch.testing.assert_close(tattn.dot_product_attention(q, k, v, impl="flash"),
                               tattn.xla_attention(q, k, v))


@pytest.mark.parametrize("impl", ["xla", "fused", "flash", "vmem"])
def test_qkv_attention_impls_match_jax_xla(impl):
    b, n, h, d = 2, 130, 2, 16
    qkv = _qkv(np.random.default_rng(36), b, n, h, d)
    from vit4hep_tpu.ops import attention as jattn

    ref = jattn.qkv_attention(jnp.asarray(qkv), h, impl="xla")
    out = tattn.qkv_attention(torch.from_numpy(qkv), h, impl=impl)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------
# f32 kernels against f32 plain versions: summation order only. Bound
# relative to the output's scale max(1, max|plain|).
CUDA_TOL = 1e-4
CUDA_SHAPES = [(4, 135, 6, 80), (2, 450, 6, 80), (2, 130, 4, 48), (3, 65, 2, 8), (2, 64, 1, 128),
               (1, 1, 3, 120), (2, 200, 2, 33)]


def _close(out, ref, tol=CUDA_TOL):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", CUDA_SHAPES)
def test_kernels_match_plain_on_cuda(cuda_device, b, n, h, d):
    rng = np.random.default_rng(40)
    qkv = torch.from_numpy(_qkv(rng, b, n, h, d)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32)).to(cuda_device)
    scale = d ** -0.5
    out, lse = tfqa.attention_fwd_kernel(qkv, h, scale)
    out_p, lse_p = tfqa.attention_fwd_plain(qkv, h, scale)
    torch.cuda.synchronize()
    _close(out, out_p)
    _close(lse, lse_p)
    delta = tfqa.attention_bwd_delta_kernel(g, out, h)
    _close(delta, tfqa.delta_plain(g, out, h))
    dqkv = tfqa.attention_bwd_kernel(qkv, g, out, lse, h, scale)
    torch.cuda.synchronize()
    _close(dqkv, tfqa.attention_bwd_plain(qkv, g, lse, h, scale))


@pytest.mark.cuda
def test_autograd_launches_the_kernels_on_cuda(cuda_device):
    b, n, h, d = 2, 135, 6, 80
    qkv = torch.randn(b, n, 3 * h * d, device=cuda_device, requires_grad=True)
    counts = [c.launches for c in (tfqa.FWD, tfqa.BWD_DELTA, tfqa.BWD_DKV, tfqa.BWD_DQ)]
    out = tattn.qkv_attention(qkv, h)
    (grad,) = torch.autograd.grad((out ** 2).sum(), qkv)
    torch.cuda.synchronize()
    assert [c.launches - k for c, k in zip(
        (tfqa.FWD, tfqa.BWD_DELTA, tfqa.BWD_DKV, tfqa.BWD_DQ), counts)] == [1, 1, 1, 1]
    x = qkv.detach().requires_grad_()
    ref = tattn.qkv_attention(x, h, impl="xla")
    (grad_p,) = torch.autograd.grad((ref ** 2).sum(), x)
    _close(out, ref)
    _close(grad, grad_p)


def _kernel_mask(name, n, device):
    if name == "layer_causal":  # ds2's (15, 1, 9) token grid at N = 135
        grid = (15, 1, 9) if n == 135 else (n // 5, 1, 5)
        return torch.from_numpy(layer_causal_mask(grid)).to(device)
    return torch.from_numpy(_one_dead_row(n, row=n // 2)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", [(4, 135, 6, 80), (2, 130, 4, 48), (2, 70, 2, 33)])
@pytest.mark.parametrize("mask_name", ["layer_causal", "dead_row"])
def test_masked_kernels_match_plain_on_cuda(cuda_device, b, n, h, d, mask_name):
    """Each masked kernel against its plain version; every launch counted."""
    rng = np.random.default_rng(41)
    qkv = torch.from_numpy(_qkv(rng, b, n, h, d)).to(cuda_device)
    g = torch.from_numpy(rng.normal(size=(b, n, h * d)).astype(np.float32)).to(cuda_device)
    mask = _kernel_mask(mask_name, n, cuda_device)
    scale = d ** -0.5
    counters = (tfqa.FWD, tfqa.BWD_DELTA, tfqa.BWD_DKV, tfqa.BWD_DQ)
    counts = [c.launches for c in counters]
    out, lse = tfqa.attention_fwd_kernel(qkv, h, scale, mask)
    out_p, lse_p = tfqa.attention_fwd_plain(qkv, h, scale, mask)
    dqkv = tfqa.attention_bwd_kernel(qkv, g, out, lse, h, scale, mask)
    torch.cuda.synchronize()
    assert [c.launches - k for c, k in zip(counters, counts)] == [1, 1, 1, 1]
    _close(out, out_p)
    _close(lse, lse_p)
    _close(dqkv, tfqa.attention_bwd_plain(qkv, g, lse_p, h, scale, mask))


@pytest.mark.cuda
def test_masked_autograd_launches_the_kernels_on_cuda(cuda_device):
    """The masked dispatch (auto, 135 tokens) runs K1 forward and backward."""
    b, n, h, d = 2, 135, 6, 80
    mask = _kernel_mask("layer_causal", n, cuda_device)
    qkv = torch.randn(b, n, 3 * h * d, device=cuda_device, requires_grad=True)
    counters = (tfqa.FWD, tfqa.BWD_DELTA, tfqa.BWD_DKV, tfqa.BWD_DQ)
    counts = [c.launches for c in counters]
    out = tattn.qkv_attention(qkv, h, mask)
    (grad,) = torch.autograd.grad((out ** 2).sum(), qkv)
    torch.cuda.synchronize()
    assert [c.launches - k for c, k in zip(counters, counts)] == [1, 1, 1, 1]
    x = qkv.detach().requires_grad_()
    ref = tattn.qkv_attention(x, h, mask, impl="xla")
    (grad_p,) = torch.autograd.grad((ref ** 2).sum(), x)
    _close(out, ref)
    _close(grad, grad_p)
