"""Port parity of K7, the streaming separated-layout flash attention
(``vit4hep_tpu_torch/ops/flash_attention.py``), against the JAX package's
``flash_attention`` (its Pallas kernels in interpret mode on this host, as
tests/test_attention.py runs them), and of the dispatch that reaches it.

CPU tests: the same numpy inputs go through both functions. Forward and
log-sum-exp at N = 50, 150 and 300 with the TPU kernel's blocks of 128 and
256 (padding, several query and key blocks), with the layer-causal mask of
a small token grid, with one wholly masked row, and with the ``scale``
override; the gradients of sum(out^2) through the port's
``autograd.Function`` against JAX's ``custom_vjp``, unmasked, masked and
with the dead row. Tolerances: forward and lse atol 2e-5, the JAX tests'
own bound for this kernel (f32 on both sides; the online softmax rescales
partial sums in another order); gradients atol 1e-4 (five f32 products per
gradient over up to 300 keys). A batched mask raises ValueError in both.

The dispatch: both packages route 10,752 tokens at hidden 480 and 6 heads
to the panel kernel K6 and 10,753 and 13,500 to K7 (``qkv_attention``'s
``auto``), with the kernels stubbed so that no 13,500-token product runs
here; ``flash_qkv_fits`` and ``fused_fits`` agree there. A tiny ViT with
``attn_impl: flash`` and ``flash_qkv_fits`` patched to False in both
packages (so both take K7) matches JAX's velocity (atol 2e-5) and every
parameter gradient of one loss (atol 1e-5) on JAX's parameters. The
smoke's ds3_long is cfm_ds3_electrons.yaml composed with four overrides
(13,500 tokens of 3 values, JAX's parameter count), and the K7 and block
stack launch counts the smoke expects add up.

CUDA tests (marker ``cuda``; skipped without a card) hold K7's three
kernels against their plain versions in f32 (tolerance 1e-4 of the scale,
K1's: summation order only), on strided views of a qkv panel, with a tail
tile and a wholly masked row, and check that autograd launches each kernel
once. On the card (no JAX there):
``python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py``.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    import vit4hep_tpu.ops.flash_attention as jfa
    import vit4hep_tpu.ops.flash_qkv_attention as jfq
    import vit4hep_tpu.ops.fused_qkv_attention as jfused
    from vit4hep_tpu.models.vit import ViT as JaxViT
    from vit4hep_tpu.ops import attention as jattn
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models.vit import ViT
from vit4hep_tpu_torch.ops import attention as tattn
from vit4hep_tpu_torch.ops import flash_attention as tfa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask
from vit4hep_tpu_torch.utils.config import compose, instantiate
from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

FWD_ATOL, GRAD_ATOL = 2e-5, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _inputs(seed, b, h, n, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))


def _dead_row(n, row=7):
    mask = layer_causal_mask((n // 6, 3, 2)) if n % 6 == 0 else np.tril(np.ones((n, n), bool))
    mask = mask.copy()
    mask[row] = False
    return mask


def _mask(kind, n):
    if kind == "none":
        return None
    return layer_causal_mask((n // 6, 3, 2)) if kind == "layer_causal" else _dead_row(n)


def _jax_fwd(q, k, v, mask, block, scale=None):
    jmask = None if mask is None else jnp.asarray(mask)
    out, res = jfa._flash_fwd(*map(jnp.asarray, (q, k, v)), jmask, block, block, scale)
    b, h, n, _ = q.shape
    return np.asarray(out), np.asarray(res[5])[:, :n, 0].reshape(b, h, n)


@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("n", [50, 150, 300])
def test_forward_matches_jax_interpret(n, block):
    q, k, v = _inputs(80 + n, 2, 2, n, 16)
    out_j, lse_j = _jax_fwd(q, k, v, None, block)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), None, block, block)
    _, lse = tfa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), 16 ** -0.5)
    np.testing.assert_allclose(out.numpy(), out_j, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=FWD_ATOL)


@pytest.mark.parametrize("kind", ["none", "layer_causal", "dead_row"])
def test_gradients_match_jax_custom_vjp(kind):
    """Forward, lse and the gradients of sum(out^2) at N = 150 (blocks of
    128: two query and key blocks, 106 pad columns); the wholly masked row
    is the mean of V, and its backward gives dq = 0."""
    b, h, n, d = 2, 3, 150, 16
    q, k, v = _inputs(85, b, h, n, d)
    mask = _mask(kind, n)
    jmask = None if mask is None else jnp.asarray(mask)
    out_j, lse_j = _jax_fwd(q, k, v, mask, 128)
    grads_j = jax.grad(lambda *a: jnp.sum(jfa.flash_attention(*a, jmask, 128, 128) ** 2),
                       argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    tmask = None if mask is None else torch.from_numpy(mask)
    xs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*xs, tmask, 128, 128)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    _, lse = tfa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), d ** -0.5, tmask)
    np.testing.assert_allclose(out.detach().numpy(), out_j, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=FWD_ATOL)
    for name, got, want in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL,
                                   err_msg=f"d{name}")
    if kind == "dead_row":
        np.testing.assert_allclose(out.detach().numpy()[:, :, 7], v.mean(2), atol=FWD_ATOL)
        assert np.all(lse.numpy()[:, :, 7] == np.float32(-1e30))
        assert np.all(grads[0].numpy()[:, :, 7] == 0)


def test_scale_override_matches_jax():
    q, k, v = _inputs(86, 1, 2, 40, 16)
    out_j, lse_j = _jax_fwd(q, k, v, None, 256, 0.1)
    out = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=0.1)
    _, lse = tfa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), 0.1)
    np.testing.assert_allclose(out.numpy(), out_j, atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=FWD_ATOL)


def test_batched_mask_raises_in_both_packages():
    q, k, v = _inputs(87, 1, 2, 20, 8)
    batched = np.ones((1, 2, 20, 20), bool)
    with pytest.raises(ValueError, match="shared \\(N, N\\) mask"):
        jfa.flash_attention(*map(jnp.asarray, (q, k, v)), jnp.asarray(batched))
    with pytest.raises(ValueError, match="shared \\(N, N\\) mask"):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), torch.from_numpy(batched))


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------
def _jax_route(n, monkeypatch):
    """The kernel JAX's qkv_attention(auto) takes at n tokens, hidden 480,
    6 heads (trace only)."""
    taken = []
    for mod, name, tag in ((jfused, "fused_qkv_attention", "K1"),
                           (jfq, "flash_qkv_attention", "K6"), (jfa, "flash_attention", "K7")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _t=tag, **kw: (taken.append(_t),
                                                                          _r(*a, **kw))[1])
    jax.eval_shape(lambda x: jattn.qkv_attention(x, 6),
                   jax.ShapeDtypeStruct((1, n, 3 * 480), jnp.float32))
    return taken


def _port_route(n, monkeypatch):
    """The kernel the port's qkv_attention(auto) takes, each stubbed to
    zeros of its output's shape on the meta device."""
    taken = []
    monkeypatch.setattr(tattn, "fused_qkv_attention",
                        lambda qkv, h, *a: (taken.append("K1"), qkv[..., :qkv.shape[-1] // 3])[1])
    monkeypatch.setattr(tattn, "flash_qkv_attention",
                        lambda qkv, h, *a: (taken.append("K6"), qkv[..., :qkv.shape[-1] // 3])[1])
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda q, *a: (taken.append("K7"), torch.zeros_like(q))[1])
    out = tattn.qkv_attention(torch.zeros(1, n, 3 * 480, device="meta"), 6)
    assert out.shape == (1, n, 480)
    return taken


@pytest.mark.parametrize("n,kernel", [(10752, "K6"), (10753, "K7"), (13500, "K7")])
def test_auto_routes_long_sequences_as_jax(n, kernel, monkeypatch):
    """The port's twin of tests/test_attention.py:1024: past the panel
    bound (10,752 tokens at hidden 480) ``auto`` reaches K7's wrapper."""
    assert tattn.flash_qkv_fits(n, 480, num_heads=6) == jfq.flash_qkv_fits(n, 480, num_heads=6) \
        == (kernel == "K6")
    assert not tattn.fused_fits(n, 480, 6)  # past 2048 tokens in both packages
    assert _jax_route(n, monkeypatch) == [kernel]
    assert _port_route(n, monkeypatch) == [kernel]


def test_vit_with_flash_past_the_panel_bound_matches_jax(monkeypatch):
    """A tiny ViT (hidden 24, 2 heads, depth 2, 12 tokens of patch_shape
    [3, 1, 1]) with ``attn_impl: flash``; ``flash_qkv_fits`` patched to
    False in both packages, so that every block takes K7 (the port's plain
    version, counted)."""
    monkeypatch.setattr(jfq, "flash_qkv_fits", lambda *a, **kw: False)
    monkeypatch.setattr(tattn, "flash_qkv_fits", lambda *a, **kw: False)
    calls = []
    real = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a, **kw: (calls.append(1),
                                                                  real(*a, **kw))[1])
    param = dict(dim=3, condition_dim=5, hidden_dim=24, out_channels=1, depth=2, num_heads=2,
                 mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                 causal_attn=False, num_patches=[[2, 2, 3]], patch_dim=3, attn_impl="flash",
                 fused_block=False, compute_dtype="float32")
    rng = np.random.default_rng(88)
    x = rng.normal(size=(3, 12, 3)).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    target = rng.normal(size=(3, 12, 3)).astype(np.float32)
    jnet = JaxViT(param)
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape).astype(np.float32),
        jnet.init(jax.random.PRNGKey(0), x, t, c))
    ref = np.asarray(jnet.apply(params, x, t, c))
    grads_j = jax.grad(lambda p: jnp.mean((jnet.apply(p, x, t, c) - target) ** 2))(params)

    net = ViT(param)
    net.load_state_dict(convert_vit_params(params))
    out = net(*map(torch.from_numpy, (x, t, c)))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=FWD_ATOL, rtol=1e-5)
    ((out - torch.from_numpy(target)) ** 2).mean().backward()
    want = convert_vit_params(grads_j)
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(want) == set(grads)
    for key, g in want.items():
        np.testing.assert_allclose(grads[key].numpy(), g.numpy(), atol=1e-5, err_msg=key)
    assert len(calls) == param["depth"]


# ---------------------------------------------------------------------------
# ds3_long, the smoke's 13,500-token path
# ---------------------------------------------------------------------------
ROOT = Path(__file__).resolve().parent.parent
LONG_OVERRIDES = ["model.patch_shape=[3,1,1]", "model.net.param.num_patches=[[15,50,18]]",
                  "model.net.param.patch_dim=3", "model.net.param.fused_block=false"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k7", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ds3_long_is_the_ds3_config_with_finer_patches():
    """ds3_long is cfm_ds3_electrons.yaml with patches of (3, 1, 1): the
    smoke's dict equals the YAML composed with four overrides; the model
    takes 13,500 tokens of 3 values, routes every block to K7 and has JAX's
    parameter count."""
    smoke = _chip_smoke()
    cfg = compose(str(ROOT / "configs"), "calochallenge/cfm/calochallenge_ds3",
                  ["data_dir=/nonexistent", *LONG_OVERRIDES])
    assert cfg.to_container()["model"] == smoke.DS3_LONG_MODEL
    model = instantiate(smoke.DS3_LONG_MODEL)
    assert model.token_shape(2) == (2, 13500, 3)
    p = model.net.cfg
    assert (p.fused_block, p.attn_impl, p.hidden_dim, p.depth, p.num_heads) == \
        (False, "auto", 480, 6, 6)
    assert not tattn.flash_qkv_fits(13500, 480, num_heads=6)
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"),
                                         "calochallenge/cfm/calochallenge_ds3",
                                         overrides=["data_dir=/nonexistent", *LONG_OVERRIDES]).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    assert model.param_count() == sum(math.prod(a.shape) for a in jax.tree.leaves(shapes))


def test_chip_smoke_k7_and_stack_launch_counts():
    """The launches the smoke expects: 6 K7 forwards per train step and per
    validation batch (or net eval), 6 of each backward pass per step, and a
    pre-pass before each forward and each backward; the block stack's three
    backward arms."""
    smoke = _chip_smoke()
    want = smoke.composed_launches("k7", 3, 1)
    assert {k: v for k, v in want.items() if v} == {
        "flash_attn_split": 42, "flash_attn_fwd": 24, "flash_attn_bwd_dkv": 18,
        "flash_attn_bwd_dq": 18}
    res, xla, rec = (smoke.stack_launches(v) for v in ("res", "xla", "recompute"))
    assert res["vit_train_gemm"] == 30 and res["qkv_attn_bwd_dq"] == 6
    assert xla["vit_train_gemm"] == 24 and xla["vit_gemm_nt"] == 0
    assert (rec["vit_gemm"], rec["vit_attention"], rec["vit_train_gemm"]) == (44, 11, 30)
    assert set(smoke.REPLACES) >= {"flash_attn_split", "flash_attn_fwd", "flash_attn_bwd_dkv",
                                   "flash_attn_bwd_dq"}
    assert all(k in smoke.TOL for k in smoke.REPLACES)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _cuda_case(device, b, h, n, d, dead_row):
    gen = torch.Generator(device=device).manual_seed(90 + n)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=device)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    g = torch.randn(b, n, h * d, generator=gen, device=device).reshape(b, n, h, d) \
        .permute(0, 2, 1, 3)
    mask = None
    if dead_row:
        mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=device))
        mask[min(7, n - 1)] = False
    return q, k, v, g, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,d,dead_row", [(2, 3, 150, 80, False), (2, 3, 150, 80, True),
                                              (1, 2, 77, 16, True), (2, 6, 450, 80, False)])
def test_kernels_match_plain_on_cuda(cuda_device, b, h, n, d, dead_row):
    q, k, v, g, mask = _cuda_case(cuda_device, b, h, n, d, dead_row)
    scale = d ** -0.5
    out, lse = tfa.flash_fwd_kernel(q, k, v, scale, mask)
    out_p, lse_p = tfa.flash_fwd_plain(q, k, v, scale, mask)
    delta = tfa.delta_plain(g, out)
    dk, dv = tfa.flash_bwd_dkv_kernel(q, k, v, g, lse, delta, scale, mask)
    dq = tfa.flash_bwd_dq_kernel(q, k, v, g, lse, delta, scale, mask)
    want = tfa.flash_bwd_plain(q, k, v, g, out, lse, scale, mask)
    torch.cuda.synchronize()
    for got, ref in ((out, out_p), (lse, lse_p), (dq, want[0]), (dk, want[1]), (dv, want[2])):
        scale_ = max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= 1e-4 * scale_
    if dead_row:
        assert torch.equal(dq[:, :, min(7, n - 1)], torch.zeros_like(dq[:, :, 0]))


@pytest.mark.cuda
def test_autograd_launches_each_kernel_once_on_cuda(cuda_device):
    q, k, v, g, _ = _cuda_case(cuda_device, 1, 2, 200, 80, False)
    xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    for c in (tfa.SPLIT, tfa.FWD, tfa.BWD_DKV, tfa.BWD_DQ):
        c.reset()
    tfa.flash_attention(*xs).backward(g)
    torch.cuda.synchronize()
    assert (tfa.FWD.launches, tfa.BWD_DKV.launches, tfa.BWD_DQ.launches) == (1, 1, 1)
    assert tfa.SPLIT.launches == 2  # one before the forward, one before the backward
    want = torch.autograd.grad(tattn.xla_attention(*xs), xs, g)
    for got, ref in zip((t.grad for t in xs), want):
        assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
