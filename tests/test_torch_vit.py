"""Port parity of the whole-ViT forward module (kernel K2v) and ViTNet
against the JAX package.

CPU tests run at a tiny size (depth 2, hidden 48, 4 heads, 12 tokens): the
same numpy inputs, or the JAX params converted by
vit4hep_tpu_torch.utils.jax_params, go through the JAX function and the
port's counterpart in float32. The JAX Pallas kernel runs in interpret mode
(f32), as the JAX package's own tests run it here: ``_vit_kernel``, the
masked ``_vit_kernel_masked`` with the layer-causal mask of the (2, 2, 3)
token grid, and the grouped ``_vit_kernel_g`` at groups 2 and 4. Tolerance
atol=2e-5, rtol=1e-5: f32 on both sides, differing only in summation order.

CUDA tests (marker ``cuda``) hold each hand-written kernel against its plain
version on the card at the ds2 shapes; they skip without one. On the card
(no JAX there): ``python -m pytest --noconftest -m cuda tests/test_torch_vit.py``.
"""

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax

    from vit4hep_tpu.models.vit import ViT as JaxViT
    from vit4hep_tpu.models.vit import sampling_variant as jax_sampling_variant
    from vit4hep_tpu.ops import fused_dit_block as jfdb
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models.vit import ViT, sampling_variant
from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask
from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _vit_args(rng, b=3, n=12, pdim=6, h=48, depth=2, fdim=96, out=6):
    def w(*shape, s=0.1):
        return (rng.normal(size=shape) * s).astype(np.float32)

    return [w(b, n, pdim, s=1.0), w(n, h, s=1.0), w(b, depth, 6, h), w(b, 2, h),
            w(pdim, h), w(h), w(depth, h, 3 * h), w(depth, 3 * h), w(depth, h, h), w(depth, h),
            w(depth, h, fdim), w(depth, fdim), w(depth, fdim, h), w(depth, h), w(h, out), w(out)]


def test_vit_forward_plain_matches_jax_reference():
    args = _vit_args(np.random.default_rng(0))
    ref = jfdb.vit_forward_reference(*args, None, 4, 12 ** -0.5)
    port = tfdb.fused_vit_forward(*map(torch.from_numpy, args), None, 4, 12 ** -0.5)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_vit_forward_plain_matches_jax_kernel_interpret():
    args = _vit_args(np.random.default_rng(1))
    ref = jfdb.fused_vit_forward(*args, None, 4, 12 ** -0.5, 1)
    port = tfdb.fused_vit_forward(*map(torch.from_numpy, args), None, 4, None, 1)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_dit_block_plain_matches_jax_reference():
    rng = np.random.default_rng(2)
    args = _vit_args(rng)
    x = rng.normal(size=(3, 12, 48)).astype(np.float32)
    blk = [args[2][:, 0], *(a[0] for a in args[6:14])]
    ref = jfdb.dit_block_reference(x, *blk, None, 4, 12 ** -0.5)
    port = tfdb.dit_block_reference(torch.from_numpy(x), *map(torch.from_numpy, blk), None, 4,
                                    12 ** -0.5)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


CAUSAL_12 = layer_causal_mask((2, 2, 3))  # the (2, 2, 3) token grid's 12 tokens


def test_fused_vit_forward_mask_not_ported():
    """The masked forward (CPU path) against JAX ``_vit_kernel_masked`` in
    interpret mode; a batched mask is refused as in JAX."""
    args = _vit_args(np.random.default_rng(3))
    ref = jfdb.fused_vit_forward(*args, CAUSAL_12, 4, 12 ** -0.5, 1)
    port = tfdb.fused_vit_forward(*map(torch.from_numpy, args), torch.from_numpy(CAUSAL_12), 4,
                                  None)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    unmasked = tfdb.fused_vit_forward(*map(torch.from_numpy, args), None, 4, None)
    assert (port - unmasked).abs().max() > 1e-3  # the mask changed the result
    with pytest.raises(ValueError, match="shared"):
        tfdb.fused_vit_forward(*map(torch.from_numpy, args),
                               torch.ones(3, 12, 12, dtype=torch.bool), 4, None)


@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "causal"])
def test_fused_vit_forward_matches_jax_grouped_kernel(group, masked):
    """JAX's grouped kernel (G elements per grid cell, block-diagonal mask,
    batch 3 padded to a multiple of G) computes the ungrouped function,
    which the port computes for any ``group``."""
    args = _vit_args(np.random.default_rng(8))
    mask = CAUSAL_12 if masked else None
    ref = jfdb.fused_vit_forward(*args, mask, 4, 12 ** -0.5, group)
    port = tfdb.fused_vit_forward(*map(torch.from_numpy, args),
                                  None if mask is None else torch.from_numpy(mask), 4, None,
                                  group)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _vit_param(fused, causal=False):
    return dict(dim=3, condition_dim=5, hidden_dim=48, out_channels=1, depth=2, num_heads=4,
                mlp_ratio=2, pos_embedding_coords="cylindrical", learn_pos_embed=True,
                causal_attn=causal, num_patches=[[2, 2, 3]], patch_dim=6, attn_impl="auto",
                fused_block=fused, compute_dtype="float32")


@pytest.mark.parametrize("fused,causal", [(False, False), ("sample", False), (False, True),
                                          ("sample", True)],
                         ids=["False", "sample", "False-causal", "sample-causal"])
def test_vitnet_matches_jax(fused, causal):
    """The composed net and the `fused_block: sample` twin (the whole-ViT
    kernel path), with non-zero adaLN and final-layer weights, plain and
    layer-causal (``causal_attn``: the mask is a buffer outside the state
    dict)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 12, 6)).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    c = rng.normal(size=(3, 5)).astype(np.float32)
    jnet = JaxViT(_vit_param(fused, causal))
    params = jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, 0.1, a.shape).astype(np.float32),
        jnet.init(jax.random.PRNGKey(0), x, t, c))
    ref = np.asarray(jax_sampling_variant(jnet).apply(params, x, t, c))

    net = ViT(_vit_param(fused, causal))
    assert "attn_mask" not in net.state_dict()
    assert (net.attn_mask is not None) == causal
    net.load_state_dict(convert_vit_params(params))
    twin = sampling_variant(net)
    assert twin.cfg.fused_block is (True if fused else False)
    assert net.cfg.fused_block == fused  # the twin leaves the training net alone
    assert twin.x_embedder.weight is net.x_embedder.weight  # and shares its params
    with torch.no_grad():
        port = twin(*map(torch.from_numpy, (x, t, c)))
    np.testing.assert_allclose(port.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_linear_epilogues_plain_semantics():
    """The plain versions of the GEMM epilogues, against their definitions."""
    rng = np.random.default_rng(5)
    a, w = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((6, 8), (8, 5)))
    bias = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    pos = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    gate = torch.from_numpy(rng.normal(size=(2, 5)).astype(np.float32))
    y = a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float() + bias
    torch.testing.assert_close(tfdb.linear_plain(a, w, bias, tfdb.EPI_BIAS), y)
    torch.testing.assert_close(tfdb.linear_plain(a, w, bias, tfdb.EPI_BIAS_POS, pos=pos, n_tok=3),
                               y + torch.cat([pos, pos]))
    resid = torch.zeros(6, 5)
    out = tfdb.linear_plain(a, w, bias, tfdb.EPI_GATED_RESID, out=resid, gate=gate, n_tok=3)
    assert out is resid
    torch.testing.assert_close(out, torch.cat([gate[:1].expand(3, 5), gate[1:].expand(3, 5)]) * y)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version at the ds2 shapes
# ---------------------------------------------------------------------------
DS2 = dict(b=8, n=135, pdim=48, h=480, depth=6, fdim=1920, out=48)


def _bf16_close(out, ref, rel=2e-2):
    """bf16 multiplicands: ~3 significant digits per product; the bound is
    relative to the output's scale."""
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
def test_vit_kernels_match_plain_on_cuda(cuda_device):
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(a).to(cuda_device) for a in _vit_args(rng, **DS2)]
    tokens, pos, mods, fmod, wemb, bemb, wqkv, bqkv = args[:8]
    m = DS2["b"] * DS2["n"]
    x = torch.randn(m, DS2["h"], device=cuda_device)
    h = tfdb.modln(x, mods[:, 0, 0], mods[:, 0, 1], DS2["n"])
    _bf16_close(h, tfdb.modln_plain(x, mods[:, 0, 0], mods[:, 0, 1], DS2["n"]))
    w = wqkv[0].to(torch.bfloat16)
    qkv = tfdb.linear(h, w, bqkv[0], tfdb.EPI_BIAS, n_tok=DS2["n"])
    torch.testing.assert_close(qkv, tfdb.linear_plain(h, w, bqkv[0], tfdb.EPI_BIAS),
                               atol=1e-3, rtol=1e-3)
    ctx = tfdb.attention(qkv.reshape(DS2["b"], DS2["n"], -1), 6, 80 ** -0.5)
    _bf16_close(ctx, tfdb.attention_plain(qkv.reshape(DS2["b"], DS2["n"], -1), 6, 80 ** -0.5))
    out = tfdb.fused_vit_forward(*args, None, 6, None)
    torch.cuda.synchronize()
    ref = tfdb.vit_forward_reference(*args, None, 6, 80 ** -0.5)
    _bf16_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,heads", [
    (dict(b=3, n=12, pdim=6, h=48, depth=2, fdim=96, out=6), 4),  # the CPU tests' shapes
    (dict(b=2, n=37, pdim=10, h=96, depth=1, fdim=200, out=10), 3),  # no dim a tile multiple
])
def test_fused_vit_forward_edge_shapes_on_cuda(cuda_device, shape, heads):
    """Edge tiles in every GEMM dimension and fewer tokens than lanes."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _vit_args(np.random.default_rng(7), **shape)]
    counts = (tfdb.GEMM.launches, tfdb.MODLN.launches, tfdb.ATTENTION.launches)
    out = tfdb.fused_vit_forward(*args, None, heads, None)
    torch.cuda.synchronize()
    depth = shape["depth"]
    assert (tfdb.GEMM.launches - counts[0], tfdb.MODLN.launches - counts[1],
            tfdb.ATTENTION.launches - counts[2]) == (2 + 4 * depth, 2 * depth + 1, depth)
    d = shape["h"] // heads
    _bf16_close(out, tfdb.vit_forward_reference(*args, None, heads, d ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,mask_grid", [(4, 450, None), (4, 135, (15, 1, 9)),
                                           (2, 450, (15, 5, 6))],
                         ids=["ds3", "ds2-causal", "ds3-causal"])
def test_attention_kernel_matches_plain_on_cuda(cuda_device, b, n, mask_grid):
    """K2v's streaming attention at ds3's 450 tokens (above what a resident
    K/V fits) and with the layer-causal mask; each launch counted."""
    qkv = torch.from_numpy(
        np.random.default_rng(9).normal(size=(b, n, 1440)).astype(np.float32)).to(cuda_device)
    mask = None if mask_grid is None else \
        torch.from_numpy(layer_causal_mask(mask_grid)).to(cuda_device)
    count = tfdb.ATTENTION.launches
    ctx = tfdb.attention(qkv, 6, 80 ** -0.5, mask)
    torch.cuda.synchronize()
    assert tfdb.ATTENTION.launches - count == 1
    _bf16_close(ctx, tfdb.attention_plain(qkv, 6, 80 ** -0.5, mask), rel=8e-3)


@pytest.mark.cuda
def test_masked_fused_vit_forward_on_cuda(cuda_device):
    """The whole masked forward at the ds2 widths against the plain one."""
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _vit_args(np.random.default_rng(10), **DS2)]
    mask = torch.from_numpy(layer_causal_mask((15, 1, 9))).to(cuda_device)
    count = tfdb.ATTENTION.launches
    out = tfdb.fused_vit_forward(*args, mask, 6, None)
    torch.cuda.synchronize()
    assert tfdb.ATTENTION.launches - count == DS2["depth"]
    _bf16_close(out, tfdb.vit_forward_reference(*args, mask, 6, 80 ** -0.5))


def test_cfm_batch_loss_is_the_flow_matching_loss():
    """CFM.batch_loss (plain PyTorch) against its definition with the same
    draws: t ~ U(0, 1) per element, x_0 ~ N(0, 1), linear trajectory."""
    from vit4hep_tpu_torch.models.calochallenge import CaloChallengeCFM

    param = dict(_vit_param(False), num_patches=[[2, 1, 3]], patch_dim=12)
    model = CaloChallengeCFM(ViT(param), patch_shape=[3, 4, 1], shape=[6, 4, 3])
    torch.nn.init.normal_(model.net.final_layer.linear.weight)
    x = torch.randn(4, 1, 6, 4, 3)
    c = torch.randn(4, 5)
    loss = model.batch_loss(x, c, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(1)
    t = torch.rand((4, 1, 1, 1, 1), generator=g)
    x_0 = torch.randn(x.shape, generator=g)
    v = model(((1 - t) * x_0 + t * x), t.reshape(-1, 1), c)
    torch.testing.assert_close(loss, torch.mean((v - (x - x_0)) ** 2))
    assert loss.item() > 0
