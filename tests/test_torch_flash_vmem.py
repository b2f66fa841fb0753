"""Port parity of the composed DiT block's opt-in kernels against the JAX
package: K8 ``vmem_attention`` (``attn_impl: vmem``), K6
``flash_qkv_attention`` (``attn_impl: flash``) and K9 ``fused_mlp_half``
(``fused_mlp: true``), each kernel module and the tiny CFM ViT that runs
them.

CPU tests: the same numpy inputs go through the JAX function (its Pallas
kernels in interpret mode, f32, as tests/test_attention.py runs them) and
the port's (its plain versions, ``mm_dtype`` f32). K8 and K6: the forward,
the log-sum-exp and the gradient of sum(out^2), unmasked, with the
layer-causal mask of a small token grid, and with one wholly masked row; K6
at N = 150 with blocks of 128, so that it spans several key blocks and pads.
Tolerances: forward and lse atol 2e-5 (f32 on both sides, summation order
only); gradients atol 1e-4 for K8 and 5e-4 for K6, as the JAX tests hold
their own kernels (the online softmax's rescaling adds rounding). K9: the
forward and the VJP of every argument at x (2, 13, 32), F 128, atol 2e-5
and 1e-4. The tiny ViT (depth 2, hidden 48, 2 heads, 12 tokens) with each
setting takes JAX's parameters through ``utils/jax_params.py``: its
velocity atol 2e-5, the loss of one train step rtol 1e-5 and every
parameter's gradient atol 1e-5 (a gradient is ~1e-2 here; f32 through two
blocks). The energy net's attention routes as JAX's: ``fused`` raises
``ValueError`` in both packages, and ``vmem`` fails on its cross-attention
in both.

CUDA tests (marker ``cuda``) hold each kernel against its plain version on
bf16-rounded multiplicands (``mm_dtype`` bf16: summation order and ``exp``
only) and check that autograd launches the kernels; they skip without a
card. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_flash_vmem.py``.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.models.energy_transformer import \
        ParallelTransformer as JaxParallelTransformer
    from vit4hep_tpu.models.vit import ViT as JaxViT
    from vit4hep_tpu.ops import flash_qkv_attention as jflash
    from vit4hep_tpu.ops import fused_mlp as jmlp
    from vit4hep_tpu.ops import vmem_attention as jvmem
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models.energy_transformer import ParallelTransformer
from vit4hep_tpu_torch.models.vit import ViT, ViTParams
from vit4hep_tpu_torch.ops import attention as tattn
from vit4hep_tpu_torch.ops import flash_qkv_attention as tflash
from vit4hep_tpu_torch.ops import fused_mlp as tmlp
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops import vmem_attention as tvmem
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask
from vit4hep_tpu_torch.utils.jax_params import convert_energy_params, convert_vit_params

FWD_ATOL = 2e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _dead_row(n, row=3):
    """A causal mask whose row ``row`` attends to no key."""
    mask = np.tril(np.ones((n, n), bool))
    mask[row] = False
    return mask


def _mask(kind, n, grid):
    if kind == "none":
        return None
    return layer_causal_mask(grid) if kind == "layer_causal" else _dead_row(n)


MASK_KINDS = ["none", "layer_causal", "dead_row"]


# ---------------------------------------------------------------------------
# K8: vmem_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_vmem_attention_matches_jax_interpret(kind):
    b, h, n, d = 2, 3, 40, 16
    rng = np.random.default_rng(60)
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = _mask(kind, n, (5, 4, 2))
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, res = jvmem._vmem_fwd(*map(jnp.asarray, (q, k, v)), jmask)
    grads_j = jax.grad(lambda *a: jnp.sum(jvmem.vmem_attention(*a, jmask) ** 2),
                       argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tmask = None if mask is None else torch.from_numpy(mask)
    xs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tvmem.vmem_attention(*xs, tmask)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    _, lse = tvmem.vmem_fwd_plain(*map(torch.from_numpy, (q, k, v)), d ** -0.5, tmask)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[5]).reshape(b, h, n), atol=FWD_ATOL)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"d{name}")
    if kind == "dead_row":  # the wholly masked row attends to every key equally
        np.testing.assert_allclose(out.detach().numpy()[:, :, 3], v.mean(2), atol=FWD_ATOL)


def test_vmem_attention_takes_strided_views_and_refuses_what_jax_cannot_run():
    """The ViT's split of its qkv panel goes in as views; q and k of other
    lengths (cross-attention) and a batched mask raise ValueError."""
    b, n, h, d = 2, 12, 2, 8
    qkv = torch.from_numpy(np.random.default_rng(61).normal(size=(b, n, 3 * h * d))
                           .astype(np.float32))
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    torch.testing.assert_close(tvmem.vmem_attention(q, k, v),
                               tattn.xla_attention(q, k, v), atol=2e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="tokens"):
        tvmem.vmem_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError, match="shared"):
        tvmem.vmem_attention(q, k, v, torch.ones(b, h, n, n, dtype=torch.bool))
    for impl in ("vmem", "flash"):  # the dispatch's plain versions refuse it too
        with pytest.raises(ValueError, match="tokens"):
            tattn.dot_product_attention(q, k[:, :, :1], v[:, :, :1], impl=impl)


# ---------------------------------------------------------------------------
# K6: flash_qkv_attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_flash_qkv_attention_matches_jax_interpret(kind):
    b, h, d, n = 2, 2, 8, 150
    rng = np.random.default_rng(62)
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = _mask(kind, n, (10, 3, 5))
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, res = jflash._flash_qkv_fwd(jnp.asarray(qkv), h, jmask, None, 128, 128)
    grad_j = jax.grad(lambda x: jnp.sum(jflash.flash_qkv_attention(x, h, jmask, None, 128, 128)
                                        ** 2))(jnp.asarray(qkv))

    tmask = None if mask is None else torch.from_numpy(mask)
    x = torch.from_numpy(qkv).requires_grad_()
    out = tflash.flash_qkv_attention(x, h, tmask, None, 128, 128)
    (grad,) = torch.autograd.grad((out ** 2).sum(), x)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    for block_k in (128, tflash.TILE):  # JAX's key blocks and the kernels' tiles
        _, lse = tflash.flash_fwd_plain(torch.from_numpy(qkv), h, d ** -0.5, tmask,
                                        block_k=block_k)
        np.testing.assert_allclose(lse.numpy(), np.asarray(res[3])[:, :n], atol=FWD_ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j), atol=5e-4)
    if kind == "dead_row":  # the mean of V over the real keys, not the padded 256
        v = qkv[..., 2 * h * d:].reshape(b, n, h, d)
        np.testing.assert_allclose(out.detach().numpy()[:, 3].reshape(b, h, d), v.mean(1),
                                   atol=FWD_ATOL)


def test_flash_qkv_fits_is_jax_bound():
    for n in (135, 450, 1024, 2048, 8192, 10752, 10753, 16384, 20000):
        for hd, heads in ((480, 6), (192, 4), (1024, 8)):
            assert tflash.flash_qkv_fits(n, hd, num_heads=heads) == \
                jflash.flash_qkv_fits(n, hd, num_heads=heads), (n, hd, heads)
    assert tflash.flash_qkv_fits(10752, 480, num_heads=6)
    assert not tflash.flash_qkv_fits(10753, 480, num_heads=6)


# ---------------------------------------------------------------------------
# K9: fused_mlp_half
# ---------------------------------------------------------------------------
def _mlp_args(rng, b=2, t=13, hdim=32, fdim=128):
    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return [w(b, t, hdim, s=1.0), w(b, hdim, s=0.3), w(b, hdim, s=0.3), w(b, hdim, s=0.3),
            w(hdim, fdim), w(fdim), w(fdim, hdim), w(hdim)]


def test_fused_mlp_half_matches_jax_interpret():
    args = _mlp_args(np.random.default_rng(63))
    jargs = [jnp.asarray(a) for a in args]
    out_j = jmlp.fused_mlp_half(*jargs)
    grads_j = jax.grad(lambda *a: jnp.sum(jmlp.fused_mlp_half(*a) ** 2),
                       argnums=tuple(range(8)))(*jargs)
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tmlp.fused_mlp_half(*xs)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jmlp.mlp_half_reference(*jargs)), atol=FWD_ATOL)
    for i, (got, want) in enumerate(zip(grads, grads_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, err_msg=f"arg {i}")


# ---------------------------------------------------------------------------
# the slice: a tiny CFM ViT with each setting
# ---------------------------------------------------------------------------
def _vit_param(**kw):
    return {**dict(dim=3, condition_dim=5, hidden_dim=48, out_channels=1, depth=2, num_heads=2,
                   mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                   causal_attn=False, num_patches=[[2, 2, 3]], patch_dim=6, attn_impl="auto",
                   fused_block=False, compute_dtype="float32"), **kw}


SETTINGS = {"vmem": dict(attn_impl="vmem"), "flash": dict(attn_impl="flash"),
            "fused_mlp": dict(fused_mlp=True),
            "vmem-causal": dict(attn_impl="vmem", causal_attn=True)}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_vitnet_settings_match_jax(setting, monkeypatch):
    """The velocity, and the loss and every parameter's gradient of one
    train step (mean squared error against a target), of the composed ViT
    with the setting, on JAX's parameters; the port's kernel modules must
    be the ones that run."""
    calls = []
    for mod, name in ((tvmem, "vmem_fwd_plain"), (tflash, "flash_fwd_plain"),
                      (tmlp, "mlp_half_plain")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                           _r(*a, **k))[1])
    rng = np.random.default_rng(64)
    x = rng.normal(size=(3, 12, 6)).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    target = rng.normal(size=(3, 12, 6)).astype(np.float32)
    param = _vit_param(**SETTINGS[setting])
    jnet = JaxViT(param)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape).astype(np.float32),
        jnet.init(jax.random.PRNGKey(0), x, t, c))

    def jloss(p):
        return jnp.mean((jnet.apply(p, x, t, c) - target) ** 2)

    ref = np.asarray(jnet.apply(params, x, t, c))
    loss_j, grads_j = jax.value_and_grad(jloss)(params)

    net = ViT(param)
    net.load_state_dict(convert_vit_params(params))
    out = net(*map(torch.from_numpy, (x, t, c)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=FWD_ATOL, rtol=1e-5)
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    want = convert_vit_params(grads_j)
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(want) == set(grads)
    for k, g in want.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), atol=1e-5, err_msg=k)
    expect = {"vmem": "vmem_fwd_plain", "flash": "flash_fwd_plain",
              "fused_mlp": "mlp_half_plain"}[setting.split("-")[0]]
    assert calls.count(expect) >= param["depth"]  # every block's forward


# ---------------------------------------------------------------------------
# the energy net's attention routes as JAX's
# ---------------------------------------------------------------------------
def _energy_param(impl):
    return dict(dims_in=6, dims_c=1, dim_embedding=16, nhead=2, num_encoder_layers=1,
                num_decoder_layers=1, dim_feedforward=32, activation="relu", embeds=True,
                encode_t_dim=16, encode_t_scale=30, attn_impl=impl)


def _energy_inputs():
    rng = np.random.default_rng(65)
    return (rng.normal(size=(3, 6)).astype(np.float32), rng.uniform(size=(3, 1)).astype(np.float32),
            rng.normal(size=(3, 1)).astype(np.float32))


def test_energy_net_attention_routes_as_jax():
    """Self- and cross-attention go through dot_product_attention in both
    packages: the plain path agrees, ``fused`` (the qkv-panel kernel)
    raises ValueError in both, and ``vmem`` runs the self-attention but
    fails on the 6-query, 1-key cross-attention in both (JAX's kernel
    reshapes k to q's length: TypeError; the port refuses: ValueError)."""
    x, t, c = _energy_inputs()
    jnet = JaxParallelTransformer(_energy_param("xla"))
    params = jnet.init(jax.random.PRNGKey(0), x, t, c)
    net = ParallelTransformer(_energy_param("xla"))
    net.load_state_dict(convert_energy_params(params), strict=False)
    with torch.no_grad():
        port = net(*map(torch.from_numpy, (x, t, c)))
    np.testing.assert_allclose(port.numpy(), np.asarray(jnet.apply(params, x, t, c)),
                               atol=FWD_ATOL, rtol=1e-5)
    for impl, jax_error in (("fused", ValueError), ("vmem", TypeError)):
        with pytest.raises(jax_error):
            JaxParallelTransformer(_energy_param(impl)).apply(params, x, t, c)
        net = ParallelTransformer(_energy_param(impl))
        with torch.no_grad(), pytest.raises(ValueError, match="fused" if impl == "fused"
                                            else "tokens"):
            net(*map(torch.from_numpy, (x, t, c)))


def test_energy_self_attention_runs_k8_plain_on_cpu(monkeypatch):
    """Without a condition the decoder's cross-attention reads a zero memory
    of the same length, so ``vmem`` runs K8's plain version on every
    attention, as JAX runs its kernel."""
    x, t, _ = _energy_inputs()
    calls = []
    real = tvmem.vmem_fwd_plain
    monkeypatch.setattr(tvmem, "vmem_fwd_plain",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    jnet = JaxParallelTransformer(_energy_param("vmem"))
    params = jnet.init(jax.random.PRNGKey(1), x, t, None)
    net = ParallelTransformer(_energy_param("vmem"))
    net.load_state_dict(convert_energy_params(params), strict=False)
    with torch.no_grad():
        port = net(torch.from_numpy(x), torch.from_numpy(t), None)
    np.testing.assert_allclose(port.numpy(), np.asarray(jnet.apply(params, x, t, None)),
                               atol=FWD_ATOL, rtol=1e-5)
    assert len(calls) == 2  # the decoder layer's self- and cross-attention


# ---------------------------------------------------------------------------
# the smoke's ds3 paths
# ---------------------------------------------------------------------------
def _chip_smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_flash_vmem", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_ds3_paths_and_their_launch_counts():
    """The smoke's composed ds3 paths set knobs the ViT knows on the shipped
    ds3 model, their synthetic showers have ds3's 40500 voxels, and the
    launches they expect add up: 6 blocks x (30 steps + 3 validation
    batches) forwards, 6 x 30 of each backward kernel."""
    smoke = _chip_smoke()
    for _, _, setting, param in smoke.DS3_SETTINGS + [(None, None, s, p) for _, _, p, s
                                                      in smoke.DS3_PARITY]:
        cfg = smoke._with_net_param(smoke.DS3_SHAPE_MODEL, fused_block=False, **param)
        p = ViTParams.create(cfg["net"]["param"])
        assert setting == ("fused_mlp" if p.fused_mlp else p.attn_impl)
    counts = {s: {k: v for k, v in smoke.composed_launches(s, 30, 3).items() if v}
              for s in ("auto", "vmem", "flash", "fused_mlp")}
    k1 = {"qkv_attn_fwd": 198, "qkv_attn_bwd_delta": 180, "qkv_attn_bwd_dkv": 180,
          "qkv_attn_bwd_dq": 180}
    assert counts["auto"] == k1
    assert counts["vmem"] == {"vmem_attn_fwd": 198, "vmem_attn_bwd_dq": 180,
                              "vmem_attn_bwd_dkv": 180}
    assert counts["flash"] == {"flash_qkv_fwd": 198, "qkv_attn_bwd_delta": 180,
                               "flash_qkv_bwd_dq": 180, "flash_qkv_bwd_dkv": 180}
    assert counts["fused_mlp"] == {**k1, "mlp_modln": 198, "mlp_gemm": 396}
    e_inc, showers, bounds = smoke._synthetic_showers(3, 0, "ds3")
    assert e_inc.shape == (3, 1) and showers.shape == (3, 40500) and bounds[-1] == 40500
    ratio = showers.sum(1) / e_inc[:, 0]  # 0.5-0.9 of the incident energy
    assert ((ratio > 0.499) & (ratio < 0.901)).all()
    assert smoke._synthetic_showers(3, 0)[1].shape == (3, 6480)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (bf16 multiplicands)
# ---------------------------------------------------------------------------
# kernel and plain version take the same bf16-rounded multiplicands and
# accumulate in f32: they differ by summation order and exp, which can flip
# one bf16 rounding of p or ds (2^-8 relative) on a few elements; relative to
# the output's scale max(1, max|plain|)
CUDA_TOL = 2e-3
CUDA_SHAPES = [(3, 6, 135, 80), (2, 6, 450, 80), (2, 3, 65, 33), (1, 2, 1, 16), (2, 1, 130, 128)]


def _close(out, ref, tol=CUDA_TOL):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


def _cuda_mask(kind, n, device):
    if kind == "none":
        return None
    if kind == "layer_causal":
        grid = {135: (15, 1, 9), 450: (15, 5, 6)}.get(n)
        mask = layer_causal_mask(grid) if grid else np.tril(np.ones((n, n), bool))
    else:
        mask = _dead_row(n, row=n // 2)
    return torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,d", CUDA_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_vmem_and_flash_kernels_match_plain_on_cuda(cuda_device, b, h, n, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(70)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    g = torch.randn(b, n, h * d, generator=gen, device=cuda_device)
    mask = _cuda_mask(kind, n, cuda_device)
    scale, bf = d ** -0.5, torch.bfloat16
    counters = (tflash.FWD, tfqa.BWD_DELTA, tflash.BWD_DQ, tflash.BWD_DKV, tvmem.FWD,
                tvmem.BWD_DQ, tvmem.BWD_DKV)
    counts = [c.launches for c in counters]
    out, lse = tflash.flash_fwd_kernel(qkv, h, scale, mask)
    dqkv = tflash.flash_bwd_kernel(qkv, g, out, lse, h, scale, mask)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)  # strided views
    gh = g.reshape(b, n, h, d).permute(0, 2, 1, 3)
    out8, lse8 = tvmem.vmem_fwd_kernel(q, k, v, scale, mask)
    grads8 = tvmem.vmem_bwd_kernel(q, k, v, gh, lse8, scale, mask)
    torch.cuda.synchronize()
    assert [c.launches - k0 for c, k0 in zip(counters, counts)] == [1] * 7
    out_p, lse_p = tflash.flash_fwd_plain(qkv, h, scale, mask, bf)
    _close(out, out_p)
    _close(lse, lse_p, 1e-4)
    _close(dqkv, tflash.flash_bwd_plain(qkv, g, out, lse, h, scale, mask, bf))
    out8_p, lse8_p = tvmem.vmem_fwd_plain(q, k, v, scale, mask, bf)
    _close(out8, out8_p)
    _close(lse8, lse8_p, 1e-4)
    for got, want in zip(grads8, tvmem.vmem_bwd_plain(q, k, v, gh, lse8, scale, mask, bf)):
        _close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t", [(4, 135), (2, 450), (3, 13)])
def test_fused_mlp_kernels_match_plain_on_cuda(cuda_device, b, t):
    """The chain (modulated LayerNorm, fc1 + GELU, fc2 + gated residual)
    against the plain version on the same bf16 roundings: one rounding flip
    of a bf16 hidden value, 8e-3 of the scale (chip_smoke.TOL's bound)."""
    gen = torch.Generator(device=cuda_device).manual_seed(71)
    hdim, fdim = 480, 1920
    x = torch.randn(b, t, hdim, generator=gen, device=cuda_device)
    mod = torch.randn(b, 6 * hdim, generator=gen, device=cuda_device) * 0.3
    args = (x, mod[:, 3 * hdim:4 * hdim], mod[:, 4 * hdim:5 * hdim], mod[:, 5 * hdim:],
            *(torch.randn(*s, generator=gen, device=cuda_device) * 0.05
              for s in ((hdim, fdim), (fdim,), (fdim, hdim), (hdim,))))
    counts = tmlp.MODLN.launches, tmlp.GEMM.launches
    out = tmlp.mlp_half_kernel(*args)
    torch.cuda.synchronize()
    assert (tmlp.MODLN.launches - counts[0], tmlp.GEMM.launches - counts[1]) == (1, 2)
    _close(out, tmlp.mlp_half_plain(*args, mm_dtype=torch.bfloat16), 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["vmem", "flash", "fused_mlp"])
def test_autograd_launches_the_kernels_on_cuda(cuda_device, impl):
    """A ds3-width block through autograd: K8 or K6 forward and backward
    kernels, or K9's chain forward with a plain VJP, each launched once, and
    the gradient within bf16 noise of the plain f32 path's."""
    b, n, h, d = 2, 450, 6, 80
    if impl == "fused_mlp":
        gen = torch.Generator(device=cuda_device).manual_seed(72)
        hdim, fdim = h * d, 4 * h * d
        args = [torch.randn(b, n, hdim, generator=gen, device=cuda_device)] + [
            torch.randn(*s, generator=gen, device=cuda_device) * sc
            for s, sc in (((b, hdim), 0.3),) * 3 + (((hdim, fdim), 0.05), ((fdim,), 0.05),
                                                   ((fdim, hdim), 0.05), ((hdim,), 0.05))]
        args = [a.requires_grad_() for a in args]
        counters = (tmlp.MODLN, tmlp.GEMM)
        counts = [c.launches for c in counters]
        out = tmlp.fused_mlp_half(*args)
        grads = torch.autograd.grad((out ** 2).sum(), args)
        torch.cuda.synchronize()
        assert [c.launches - k0 for c, k0 in zip(counters, counts)] == [1, 2]
        ref = tmlp.mlp_half_plain(*args)
        want = torch.autograd.grad((ref ** 2).sum(), args)
    else:
        qkv = torch.randn(b, n, 3 * h * d, device=cuda_device, requires_grad=True)
        counters = ((tvmem.FWD, tvmem.BWD_DQ, tvmem.BWD_DKV) if impl == "vmem" else
                    (tflash.FWD, tfqa.BWD_DELTA, tflash.BWD_DQ, tflash.BWD_DKV))
        counts = [c.launches for c in counters]
        out = tattn.qkv_attention(qkv, h, impl=impl)
        grads = torch.autograd.grad((out ** 2).sum(), qkv)
        torch.cuda.synchronize()
        assert [c.launches - k0 for c, k0 in zip(counters, counts)] == [1] * len(counters)
        x = qkv.detach().requires_grad_()
        ref = tattn.qkv_attention(x, h, impl="xla")
        want = torch.autograd.grad((ref ** 2).sum(), x)
    _close(out, ref, 2e-2)
    for got, w in zip(grads, want):
        _close(got, w, 2e-2)
