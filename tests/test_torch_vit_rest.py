"""The rest of the ViT in the port against the JAX package: the fixed
sin-cos positional embeddings (``learn_pos_embed: false``) and the shipped
``_tpu`` variants.

CPU tests:
- the sin-cos grids (cylindrical and cartesian 3-D, the 1-D grid with its
  halved token count) bit for bit: both packages compute them in numpy;
- ``ViT`` (composed and with ``fused_block: sample``, the K2v path's plain
  version against JAX's Pallas kernel in interpret mode) and ``ViT1D``
  with ``learn_pos_embed: false`` within 1e-5 (f32 both sides, summation
  order only); the nets have no ``pos_embed_freqs``;
- the ``_tpu`` configs (cfm_ds2_electrons_tpu, cfm_ds3_electrons_tpu: 4
  heads of 120; cinn_ds2_electrons_tpu: subnets of hidden 256 in 4 heads of
  64) compose to the port's classes with JAX's parameter counts, and a
  one-block ViT at 4 heads of 120 and a ViT1D at 4 heads of 64 match JAX.

CUDA tests (marker ``cuda``; they skip without a card) hold the kernels
at the shapes this slice adds against their plain versions: K2v at ds1's
88 and 125 tokens of 5 values and its attention at 4 heads of 120, K3 at 5
and 7 tokens, K4 on rows of 265 and 370 scalars, K1's forward and backward
at 4 heads of 120 and its forward at 4 heads of 64. On the card (no JAX
there): ``python -m pytest --noconftest -m cuda tests/test_torch_vit_rest.py``.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax

    from vit4hep_tpu.models.vit import ViT as JaxViT
    from vit4hep_tpu.models.vit import ViT1D as JaxViT1D
    from vit4hep_tpu.models.vit import sampling_variant as jax_sampling_variant
    from vit4hep_tpu.ops import pos_embed as jpe
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.models.vit import ViT, ViT1D, sampling_variant
from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops import fused_energy_decoder as tfed
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops import fused_spline as tfs
from vit4hep_tpu_torch.ops import pos_embed as tpe
from vit4hep_tpu_torch.utils.jax_params import convert_vit_params

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = 1e-5, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _perturb(params, rng, std=0.1):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + rng.normal(0, std, a.shape).astype(np.float32),
        params)


# ---------------------------------------------------------------------------
# the fixed sin-cos embeddings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("coords,num_patches,hidden,dim", [
    ("cylindrical", (15, 1, 9), 480, 3),  # ds2's grid
    ("cartesian", (15, 5, 6), 480, 3),  # ds3's
    ("cartesian", (2, 2, 3), 48, 3),
    ("cylindrical", (135, 1, 1), 192, 1),  # the 1-D grid: a ds2 cINN subnet's
    ("cartesian", (53, 1, 2), 240, 1),  # a ds1 photons cINN subnet's
])
def test_sincos_grids_match_jax_bitwise(coords, num_patches, hidden, dim):
    port = tpe.get_sincos_pos_embed(coords, num_patches, hidden, dim, 10000)
    ref = jpe.get_sincos_pos_embed(coords, num_patches, hidden, dim, 10000)
    assert port.dtype == np.float32 and port.shape == ref.shape
    rows = math.prod(num_patches) // (2 if dim == 1 else 1)
    assert port.shape == (rows, hidden // (2 if dim == 1 else 6) * (2 if dim == 1 else 6))
    np.testing.assert_array_equal(port, ref)


def test_sincos_too_narrow_raises():
    with pytest.raises(ValueError, match="too small"):
        tpe.get_sincos_pos_embed("cartesian", (2, 2, 3), 6, 3)
    with pytest.raises(ValueError, match="No sincos embedding"):
        tpe.get_sincos_pos_embed("polar", (2, 2, 3), 48, 3)


def _vit_param(coords="cylindrical", fused=False, **kw):
    return dict(dict(dim=3, condition_dim=5, hidden_dim=48, out_channels=1, depth=2,
                     num_heads=4, mlp_ratio=2, pos_embedding_coords=coords,
                     learn_pos_embed=False, causal_attn=False, num_patches=[[2, 2, 3]],
                     patch_dim=6, attn_impl="auto", fused_block=fused,
                     compute_dtype="float32"), **kw)


def _vit_vs_jax(param, n_tok, pdim, seed, scaled=False):
    """The port's net on JAX's converted params against JAX's: within 1e-5,
    absolute and relative, or with ``scaled`` 1e-5 of the output's scale
    (a wide net's O(10) outputs sum ~2000 f32 terms a value)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, n_tok, pdim)).astype(np.float32)
    t = rng.uniform(size=(3, 1)).astype(np.float32)
    c = rng.normal(size=(3, param["condition_dim"])).astype(np.float32)
    jnet = JaxViT(param)
    params = _perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, t, c), rng)
    ref = np.asarray(jax.jit(jax_sampling_variant(jnet).apply)(params, x, t, c))
    net = ViT(param)
    net.load_state_dict(convert_vit_params(params))
    with torch.no_grad():
        out = sampling_variant(net)(*map(torch.from_numpy, (x, t, c)))
    if scaled:
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL * max(1.0, np.abs(ref).max()))
    else:
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    return net, params


@pytest.mark.parametrize("coords", ["cylindrical", "cartesian"])
@pytest.mark.parametrize("fused", [False, "sample"], ids=["composed", "sample"])
def test_vit_with_sincos_embedding_matches_jax(coords, fused):
    net, params = _vit_vs_jax(_vit_param(coords, fused), 12, 6, 1)
    assert "pos_embed_freqs" not in params["params"]
    assert not hasattr(net, "pos_embed_freqs") and "_sincos" not in net.state_dict()
    np.testing.assert_array_equal(
        net.pos_embedding().numpy(), jpe.get_sincos_pos_embed(coords, (2, 2, 3), 48, 3))


def test_vit1d_with_sincos_embedding_matches_jax():
    """A non-spatial cINN subnet: 12 tokens of the grid, 6 tokens a side,
    the 1-D embedding over half the grid's count (as JAX)."""
    param = dict(dim=1, condition_dim=5, hidden_dim=32, out_channels=1, depth=2, num_heads=2,
                 mlp_ratio=2.0, learn_pos_embed=False, causal_attn=False, patch_dim=6,
                 num_patches=[[2, 2, 3]], prod_num_patches=6, x_out=7, attn_impl="auto")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 6)).astype(np.float32)
    c = rng.normal(size=(2, 5)).astype(np.float32)
    jnet = JaxViT1D(param)
    params = _perturb(jnet.init(jax.random.PRNGKey(0), x, c), rng)
    ref = np.asarray(jnet.apply(params, x, c))
    net = ViT1D(param)
    net.load_state_dict(convert_vit_params(params))
    assert not hasattr(net, "pos_embed_freqs")
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(c))
    assert out.shape == (2, 6, 42)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# the _tpu variants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,model,count", [
    ("calochallenge/cfm/calochallenge_ds2", "cfm/cfm_ds2_electrons_tpu", 26_042_528),
    ("calochallenge/cfm/calochallenge_ds3", "cfm/cfm_ds3_electrons_tpu", 26_082_890),
    ("calochallenge/cinn/calochallenge_ds2_noise", "cinn/cinn_ds2_electrons_tpu", 158_304_320),
], ids=["cfm-ds2", "cfm-ds3", "cinn-ds2"])
def test_tpu_configs_have_the_jax_parameter_counts(name, model, count):
    """Each experiment config with its ``_tpu`` model builds the port's
    classes (ported knobs only) with JAX's parameter count (JAX's from
    jax.eval_shape; the port's on the meta device)."""
    from vit4hep_tpu.utils.config import compose as jax_compose
    from vit4hep_tpu.utils.config import instantiate as jax_instantiate
    from vit4hep_tpu_torch.utils.config import compose, instantiate

    overrides = ["data_dir=/nonexistent", f"model={model}"]
    with torch.device("meta"):
        port = instantiate(compose(str(ROOT / "configs"), name, overrides)["model"])
    jmodel = jax_instantiate(jax_compose(str(ROOT / "configs"), name, overrides=overrides).model)
    shapes = jax.eval_shape(lambda k: jmodel.init_params(k), jax.random.PRNGKey(0))
    assert port.param_count() == sum(math.prod(a.shape) for a in jax.tree.leaves(shapes)) == count
    if "cinn" in name:
        sub = port.net.blocks[0].subnet1.cfg
        assert (sub.hidden_dim, sub.num_heads) == (256, 4)
    else:
        assert (port.net.cfg.hidden_dim, port.net.cfg.num_heads) == (480, 4)
        assert port.net.cfg.fused_block == "sample"


def test_tpu_head_dims_match_jax():
    """One block at the _tpu CFM's width (hidden 480 in 4 heads of 120, K2v's
    path) and a ViT1D at the _tpu cINN's (hidden 256 in 4 heads of 64), at
    a few tokens."""
    param = dict(dim=3, condition_dim=46, hidden_dim=480, out_channels=1, depth=1,
                 num_heads=4, mlp_ratio=4, pos_embedding_coords="cylindrical",
                 learn_pos_embed=True, causal_attn=False, num_patches=[[3, 1, 3]],
                 patch_dim=48, attn_impl="auto", fused_block="sample")
    _vit_vs_jax(param, 9, 48, 3, scaled=True)
    p1d = dict(dim=1, condition_dim=46, hidden_dim=256, out_channels=1, depth=1, num_heads=4,
               mlp_ratio=4.0, learn_pos_embed=True, causal_attn=False, patch_dim=24,
               num_patches=[[10, 1, 1]], prod_num_patches=10, x_out=31, attn_impl="auto")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 10, 24)).astype(np.float32)
    c = rng.normal(size=(2, 46)).astype(np.float32)
    jnet = JaxViT1D(p1d)
    params = _perturb(jax.jit(jnet.init)(jax.random.PRNGKey(0), x, c), rng, 0.05)
    ref = np.asarray(jax.jit(jnet.apply)(params, x, c))
    net = ViT1D(p1d)
    net.load_state_dict(convert_vit_params(params))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL * max(1.0, np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the card: this slice's new kernel shapes
# ---------------------------------------------------------------------------
def _w(rng, *shape, s=0.1):
    return (rng.normal(size=shape) * s).astype(np.float32)


def _bf16_close(out, ref, rel):
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("n,heads", [(88, 6), (125, 6), (135, 4), (450, 4)],
                         ids=["ds1-photons", "ds1-pions", "tpu-d120", "tpu-ds3-d120"])
def test_k2v_at_the_new_shapes_on_cuda(cuda_device, n, heads):
    """K2v's whole forward at ds1's tokens of 5 values (K = 5 and N = 5
    padded for the GEMM's TMA) and at 4 heads of 120 (DP = 128; the _tpu
    ds2 and ds3 token counts), against
    the plain version on bf16 multiplicands: 2e-2 of the scale, the smoke's
    TOL for the whole forward; the attention alone 8e-3."""
    rng = np.random.default_rng(n + heads)
    pdim = {135: 48, 450: 90}.get(n, 5)
    b, h, depth, fdim = 4, 480, 2, 1920
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        _w(rng, b, n, pdim, s=1.0), _w(rng, n, h, s=1.0), _w(rng, b, depth, 6, h),
        _w(rng, b, 2, h), _w(rng, pdim, h), _w(rng, h), _w(rng, depth, h, 3 * h),
        _w(rng, depth, 3 * h), _w(rng, depth, h, h), _w(rng, depth, h), _w(rng, depth, h, fdim),
        _w(rng, depth, fdim), _w(rng, depth, fdim, h), _w(rng, depth, h), _w(rng, h, pdim),
        _w(rng, pdim))]
    d = h // heads
    counts = (tfdb.GEMM.launches, tfdb.ATTENTION.launches)
    out = tfdb.fused_vit_forward(*args, None, heads, None)
    torch.cuda.synchronize()
    assert (tfdb.GEMM.launches - counts[0], tfdb.ATTENTION.launches - counts[1]) == \
        (2 + 4 * depth, depth)
    _bf16_close(out, tfdb.vit_forward_reference(*args, None, heads, d ** -0.5), 2e-2)
    qkv = torch.from_numpy(_w(rng, b, n, 3 * h, s=1.0)).to(cuda_device)
    _bf16_close(tfdb.attention(qkv, heads, d ** -0.5),
                tfdb.attention_plain(qkv, heads, d ** -0.5, None, torch.bfloat16), 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 7], ids=["ds1-photons", "ds1-pions"])
def test_k3_at_ds1_tokens_on_cuda(cuda_device, n):
    """K3's tensor-core kernel at the ds1 energy nets' 5 and 7 tokens (two
    elements' 10 / 14 rows in 64-row tiles), batch 33 (a ragged last CTA):
    f32 function in split TF32, 1e-4 of the scale."""
    rng = np.random.default_rng(n)
    b, dm, te, fdim, hn, depth = 33, 128, 64, 512, 512, 4
    assert tfed.tensor_core_shape(n, dm, 4, fdim, hn, depth)
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        _w(rng, b, n, dm, s=1.0), _w(rng, b, te, s=1.0), _w(rng, b, depth, dm),
        1 + _w(rng, depth, 3, dm, s=0.05), _w(rng, depth, 3, dm, s=0.05),
        _w(rng, depth, dm, 3 * dm, s=0.05), _w(rng, depth, 3 * dm, s=0.05),
        _w(rng, depth, dm, dm, s=0.05), _w(rng, depth, dm, s=0.05),
        _w(rng, depth, dm, fdim, s=0.05), _w(rng, depth, fdim, s=0.05),
        _w(rng, depth, fdim, dm, s=0.05), _w(rng, depth, dm, s=0.05),
        1 + _w(rng, dm, s=0.05), _w(rng, dm, s=0.05), _w(rng, te + dm, hn, s=0.05),
        _w(rng, hn, s=0.05), _w(rng, hn, 1, s=0.05), _w(rng, 1, s=0.05))]
    before = tfed.ENERGY_DECODER.launches
    out = tfed.fused_energy_decoder(*args, 4, "relu", 32)
    torch.cuda.synchronize()
    assert tfed.ENERGY_DECODER.launches == before + 1
    ref = tfed._reference(*args, num_heads=4, activation="relu")
    assert (out - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [265, 370], ids=["ds1-photons", "ds1-pions"])
def test_k4_on_ds1_rows_on_cuda(cuda_device, d):
    """K4 on the ds1 cINNs' rows (53 / 74 tokens x 5 scalars a side): a
    128-scalar unit spans two rows, so each row's log-determinant is summed
    across units and CTAs; 1e-4 of the scale, two launches bit for bit."""
    rng = np.random.default_rng(d)
    y = torch.from_numpy(_w(rng, 256, d, s=6.0)).to(cuda_device)
    theta = torch.from_numpy(_w(rng, 256, d, 31, s=1.0)).to(cuda_device)
    args = (10, (0.001, 0.001), (-8.0, 8.0, -8.0, 8.0), False, None)
    out = tfs.fused_binned_rqs_inverse(y, theta, *args)
    again = tfs.fused_binned_rqs_inverse(y, theta, *args)
    torch.cuda.synchronize()
    for o, r in zip(out, tfs.inverse_plain(y, theta, *args)):
        assert (o - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,heads,d,backward", [(8, 135, 4, 120, True), (16, 135, 4, 64, False),
                                                  (16, 53, 4, 60, False)],
                         ids=["tpu-cfm-d120", "tpu-cinn-d64", "ds1-cinn-d60"])
def test_k1_at_the_new_head_dims_on_cuda(cuda_device, b, n, heads, d, backward):
    """K1's forward (and, for the _tpu CFM's training, its backward) at 4
    heads of 120 and 64, and at the ds1 cINN subnets' 4 heads of 60: f32 in
    split TF32, 1e-4 of the scale as the smoke's TOL."""
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(_w(rng, b, n, 3 * heads * d, s=1.0)).to(cuda_device)
    scale = d ** -0.5
    out, lse = tfqa.attention_fwd_kernel(qkv, heads, scale)
    out_p, lse_p = tfqa.attention_fwd_plain(qkv, heads, scale)
    torch.cuda.synchronize()
    for o, r in ((out, out_p), (lse, lse_p)):
        assert (o - r).abs().max().item() <= 1e-4 * max(1.0, r.abs().max().item())
    if backward:
        g = torch.from_numpy(_w(rng, b, n, heads * d, s=1.0)).to(cuda_device)
        dqkv = tfqa.attention_bwd_kernel(qkv, g, out, lse, heads, scale)
        ref = tfqa.attention_bwd_plain(qkv, g, lse, heads, scale)
        torch.cuda.synchronize()
        assert (dqkv - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
