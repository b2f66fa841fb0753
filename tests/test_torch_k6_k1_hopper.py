"""K6's backward on wgmma (``csrc/flash_bwd_wgmma.cuh``: the dQ pass
``flash_bwd_dq_wgmma_kernel``, one sweep over 64-key tiles for 128 query
rows, and the dK/dV pass ``flash_bwd_dkv_wgmma_kernel``, 128 key rows) and
K1's forward in split TF32 (``csrc/qkv_fwd_tf32.cuh``:
``qkv_fwd_tf32_kernel``, 64 query rows a CTA, 32-key tiles).

CPU tests:
  - K6's plain backward (``mm_dtype`` f32) against JAX's
    ``flash_qkv_attention`` VJP in interpret mode at the new kernels' tile
    edges: N = 130 (a 2-row tail past the 128-row blocks and 64-key tiles)
    and N = 200 (a 72-row tail block, an 8-key tail tile); unmasked,
    layer-causal, and with one wholly masked row, whose terms must be
    exactly 0 (K6's ``where(valid, exp(s - lse), 0)``, not K8's and K1's
    p = 1). dqkv at atol 1e-4: f32 on both sides, summation order only, as
    the K8 file holds its gradients.
  - K1's plain forward against JAX's ``fused_qkv_attention`` in interpret
    mode at N = 135 and 225 (the ds2 and ds3 subnet token counts), d = 16
    and 48 (the TPU's head-packed body) and 80 (its per-head body),
    unmasked and layer-causal: context and lse at atol 2e-5 (f32 on both
    sides).
  - A torch emulation of the 3xTF32 split (tf32 by rounding the mantissa to
    its top 10 bits, as ``cvt.rna.tf32.f32`` does; products of tf32 values
    are exact in f32) held to ``chip_smoke.TOL["qkv_attn_fwd"]`` = 1e-4 of
    max(1, max|plain|) against the f32 plain forward at those shapes, and at
    least 10x closer than one TF32 product per matmul: the split keeps the
    f32 contract before any card run.
  - The smoke's records: ``REPLACES`` names the new kernels in headers that
    define them; ``TOL`` is unchanged.

CUDA tests (marker ``cuda``; they skip without a card) hold each kernel
against its plain version: K6's passes on the same bf16 roundings
(``mm_dtype`` bf16) at ``chip_smoke.TOL``'s 4e-3 of the scale, K1's
forward at 1e-4 (f32 plain), at d = 16 ... 128 and 13 (the 4-byte copy
path), the ds2, ds3 and cINN token counts, unmasked, layer-causal and with
a wholly masked row; each wrapper counts exactly one launch.
On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_k6_k1_hopper.py``.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax
    import jax.numpy as jnp

    from vit4hep_tpu.ops import flash_qkv_attention as jflash
    from vit4hep_tpu.ops import fused_qkv_attention as jfqa
except ModuleNotFoundError:
    jax = None

from vit4hep_tpu_torch.ops import flash_qkv_attention as tflash
from vit4hep_tpu_torch.ops import fused_qkv_attention as tfqa
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

ROOT = Path(__file__).resolve().parents[1]
GRAD_ATOL, FWD_ATOL = 1e-4, 2e-5
QKV_FWD_TOL = 1e-4  # chip_smoke.TOL["qkv_attn_fwd"]
MASK_KINDS = ["none", "layer_causal", "dead_row"]
LAYER_GRIDS = {130: (13, 2, 5), 135: (15, 1, 9), 200: (8, 5, 5), 225: (25, 3, 3),
               450: (15, 5, 6)}
DEAD = 7  # the wholly masked row


def _mask(kind, n):
    """None, the layer-causal mask of a token grid with n tokens (causal
    where none is listed), or a causal mask whose row DEAD attends to no
    key."""
    if kind == "none":
        return None
    if kind == "layer_causal":
        return layer_causal_mask(LAYER_GRIDS[n]) if n in LAYER_GRIDS else \
            np.tril(np.ones((n, n), bool))
    mask = np.tril(np.ones((n, n), bool))
    mask[DEAD] = False
    return mask


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_k6_k1", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ---------------------------------------------------------------------------
# the smoke's records of the new kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel,want,header", [
    ("qkv_attn_fwd", "qkv_fwd_tf32_kernel", "qkv_fwd_tf32.cuh"),
    ("flash_qkv_bwd_dq", "flash_bwd_dq_wgmma_kernel", "flash_bwd_wgmma.cuh"),
    ("flash_qkv_bwd_dkv", "flash_bwd_dkv_wgmma_kernel", "flash_bwd_wgmma.cuh")])
def test_smoke_names_the_redesigned_kernels(kernel, want, header):
    smoke = _chip_smoke()
    source, replaces = smoke.REPLACES[kernel]
    assert want in source and header in source and "attention_mma" not in source
    path = ROOT / source.split()[0].rstrip(":")
    assert path.name == header and f"{want}(" in path.read_text()
    ops = "fused_qkv_attention" if kernel == "qkv_attn_fwd" else "flash_qkv_attention"
    assert replaces.startswith(f"vit4hep_tpu/ops/{ops}.py:")
    assert smoke.TOL[kernel] == {"qkv_attn_fwd": 1e-4}.get(kernel, 4e-3)


FAKE_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN2aw22flash_fwd_wgmma_kernelILi80ELb0EEEvN4amma4ArgsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;               /* 0x00000a00ff017b82 */
                                                                        /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                   /* 0x0000000000007919 */
.L_x_0:
        /*0020*/                   BRA `(.L_x_0) ;                      /* 0xfffffffc00fc7947 */
\t\tFunction : _ZN49_GLOBAL__N__21fb8654_16_qkv_attention_cu_19e22e4816bwd_delta_kernelEv
        /*0000*/                   EXIT ;                               /* 0x000000000000794d */
"""


def test_tree_compare_reads_sass_instructions(monkeypatch):
    """``tree_compare.py sass`` compares instructions only: the addresses
    and encodings of ``cuobjdump -sass`` are stripped, per function, and an
    anonymous namespace's path hash leaves the function's name."""
    spec = importlib.util.spec_from_file_location("tree_compare_k6_k1", ROOT / "tree_compare.py")
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(stdout=FAKE_SASS)

    monkeypatch.setattr(tc.subprocess, "run", run)
    funcs = tc._sass_functions(Path("libx.so"))
    assert funcs == {"_ZN2aw22flash_fwd_wgmma_kernelILi80ELb0EEEvN4amma4ArgsE":
                     ["LDC R1, c[0x0][0x28]", "S2R R0, SR_TID.X", "BRA `(.L_x_0)"],
                     "_ZN49_GLOBAL__N__16_qkv_attention_cu_19e22e4816bwd_delta_kernelEv": ["EXIT"]}
    assert calls[0][1:] == ["-sass", "libx.so"] and calls[0][0].endswith("cuobjdump")
    assert "flash_fwd_wgmma_kernel" in tc.SASS_KERNELS["flash_qkv_attention"]


# ---------------------------------------------------------------------------
# K6's plain backward at the new kernels' tile edges (CPU, against JAX)
# ---------------------------------------------------------------------------
@pytest.mark.skipif(jax is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("n", [130, 200])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k6_plain_backward_at_the_kernel_tiles_matches_jax(n, kind):
    b, h, d = 1, 2, 16
    rng = np.random.default_rng(120 + n)
    qkv = rng.normal(size=(b, n, 3 * h * d)).astype(np.float32)
    g = rng.normal(size=(b, n, h * d)).astype(np.float32)
    mask = _mask(kind, n)
    jmask = None if mask is None else jnp.asarray(mask)
    _, res = jflash._flash_qkv_fwd(jnp.asarray(qkv), h, jmask, None, 128, 128)
    dqkv_j, _ = jflash._flash_qkv_bwd(h, None, 128, 128, res, jnp.asarray(g))

    tmask = None if mask is None else torch.from_numpy(mask)
    x, gt = torch.from_numpy(qkv), torch.from_numpy(g)
    scale = d ** -0.5
    out, lse = tflash.flash_fwd_plain(x, h, scale, tmask, block_k=tflash.TILE)
    dqkv = tflash.flash_bwd_plain(x, gt, out, lse, h, scale, tmask)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(dqkv_j), atol=GRAD_ATOL)
    if kind == "dead_row":
        # the dead row weighs every key 0: its dQ is exactly 0, and its
        # upstream gradient reaches no dK or dV
        assert (dqkv[:, DEAD, :h * d] == 0).all()
        g2 = gt.clone()
        g2[:, DEAD] = 100.0
        again = tflash.flash_bwd_plain(x, g2, out, lse, h, scale, tmask)
        torch.testing.assert_close(again[..., h * d:], dqkv[..., h * d:], atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# K1's plain forward at the subnet token counts (CPU, against JAX)
# ---------------------------------------------------------------------------
@pytest.mark.skipif(jax is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("n", [135, 225])
@pytest.mark.parametrize("d", [16, 48, 80])
@pytest.mark.parametrize("kind", ["none", "layer_causal"])
def test_k1_plain_forward_matches_jax(n, d, kind):
    b, h = 1, 2
    qkv = np.random.default_rng(130 + n + d).normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = _mask(kind, n)
    out_j, (_, _, lse_j) = jfqa._fused_fwd(jnp.asarray(qkv), h,
                                           None if mask is None else jnp.asarray(mask))
    out, lse = tfqa.attention_fwd_plain(torch.from_numpy(qkv), h, d ** -0.5,
                                        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=FWD_ATOL)


# ---------------------------------------------------------------------------
# the 3xTF32 split against the f32 contract (CPU emulation)
# ---------------------------------------------------------------------------
def _tf32(x):
    """x rounded to the nearest tf32, ties away from zero (cvt.rna.tf32.f32):
    add half of the 13 dropped mantissa bits to the magnitude, then drop
    them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_mm(a, b, terms):
    """a @ b in TF32 products accumulated in f32: with terms 3, hi hi + hi lo
    + lo hi (the kernel's split); with 1, hi hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.matmul(ah, bh)
    if terms == 3:
        out = out + torch.matmul(ah, _tf32(b - bh)) + torch.matmul(_tf32(a - ah), bh)
    return out


def _tf32_fwd(qkv, h, scale, mask, terms):
    """K1's forward with its two products in TF32: (context, lse (B, H, N))."""
    q, k, v = tfqa._heads(qkv, h, 3)
    s = _split_mm(q, k.transpose(-1, -2), terms) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)  # noqa: E741
    return tfqa._merge(_split_mm(p, v, terms) / l), (m + torch.log(l))[..., 0]


def _rel(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


@pytest.mark.parametrize("b,n,h,d", [(4, 135, 6, 80), (4, 135, 4, 48), (4, 225, 4, 48),
                                     (2, 450, 6, 80), (4, 135, 2, 16)])
@pytest.mark.parametrize("kind", ["none", "layer_causal"])
def test_split_tf32_holds_the_f32_contract(b, n, h, d, kind):
    gen = torch.Generator().manual_seed(140 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen)
    mask = _mask(kind, n)
    mask = None if mask is None else torch.from_numpy(mask)
    scale = d ** -0.5
    want = tfqa.attention_fwd_plain(qkv, h, scale, mask)
    three = _tf32_fwd(qkv, h, scale, mask, 3)
    one = _tf32_fwd(qkv, h, scale, mask, 1)
    err3 = max(_rel(got, ref) for got, ref in zip(three, want))
    err1 = max(_rel(got, ref) for got, ref in zip(one, want))
    assert err3 <= QKV_FWD_TOL, err3
    assert err3 * 10 <= err1, (err3, err1)


def test_tf32_rounding_is_round_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -9,
                      1.0 + 2.0 ** -12, 0.0])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9, 1.0, 0.0])
    assert torch.equal(_tf32(x), want)
    hi = _tf32(x)
    lo = _tf32(x - hi)
    assert torch.equal(hi + lo, x)  # these split exactly


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    assert err <= tol * scale, f"{what}: max abs error {err:.3e} > {tol} x {scale:.3g}"


# (B, N, H, d): the ds3 training and serving token count, the ds2 and cINN
# ones, the kernels' tile edges, every padded head dim and d = 13 (4-byte
# copies); (2, 130, 2, 64) masked caught a miscompiled dQ pass (flash_bwd_wgmma.cuh,
# k6_p)
K6_SHAPES = [(2, 450, 6, 80), (2, 130, 2, 16), (2, 200, 2, 32), (2, 135, 4, 48),
             (1, 65, 3, 64), (2, 130, 2, 64), (1, 200, 2, 96), (1, 130, 2, 112),
             (1, 200, 2, 128), (2, 70, 3, 13), (1, 1, 2, 80)]
K1_SHAPES = [(4, 135, 6, 80), (4, 135, 4, 48), (4, 225, 4, 48), (2, 450, 6, 80),
             (4, 135, 2, 16), (2, 65, 3, 32), (2, 200, 2, 64), (2, 130, 2, 96),
             (1, 200, 2, 112), (2, 135, 2, 128), (2, 70, 3, 13), (2, 1, 2, 80)]


def _cuda_mask(kind, n, device):
    if kind == "dead_row" and n <= DEAD:
        kind = "layer_causal"
    mask = _mask(kind, n)
    return None if mask is None else torch.from_numpy(mask).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", K6_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k6_backward_kernels_match_plain_on_cuda(cuda_device, b, n, h, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(150 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    g = torch.randn(b, n, h * d, generator=gen, device=cuda_device)
    mask = _cuda_mask(kind, n, cuda_device)
    scale, hd = d ** -0.5, h * d
    out, lse = tflash.flash_fwd_kernel(qkv, h, scale, mask)
    delta = tfqa.attention_bwd_delta_kernel(g, out, h)
    counts = [tflash.BWD_DQ.launches, tflash.BWD_DKV.launches]
    dqkv = torch.full_like(qkv, float("nan"))
    tflash.flash_bwd_dq_kernel(qkv, g, lse, delta, h, scale, dqkv, mask)
    tflash.flash_bwd_dkv_kernel(qkv, g, lse, delta, h, scale, dqkv, mask)
    torch.cuda.synchronize()
    assert [tflash.BWD_DQ.launches - counts[0], tflash.BWD_DKV.launches - counts[1]] == [1, 1]
    want = tflash.flash_bwd_plain(qkv, g, out, lse, h, scale, mask, torch.bfloat16)
    _close(dqkv[..., :hd], want[..., :hd], 4e-3, "dq")
    _close(dqkv[..., hd:2 * hd], want[..., hd:2 * hd], 4e-3, "dk")
    _close(dqkv[..., 2 * hd:], want[..., 2 * hd:], 4e-3, "dv")
    if mask is not None and n > DEAD and kind == "dead_row":
        assert (dqkv[:, DEAD, :hd] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,d", K1_SHAPES)
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_k1_tf32_forward_matches_plain_on_cuda(cuda_device, b, n, h, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(160 + n + d)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    mask = _cuda_mask(kind, n, cuda_device)
    scale = d ** -0.5
    count = tfqa.FWD.launches
    out, lse = tfqa.attention_fwd_kernel(qkv, h, scale, mask)
    torch.cuda.synchronize()
    assert tfqa.FWD.launches - count == 1
    out_p, lse_p = tfqa.attention_fwd_plain(qkv, h, scale, mask)
    _close(out, out_p, QKV_FWD_TOL, "context")
    _close(lse, lse_p, QKV_FWD_TOL, "lse")
    if mask is not None and n > DEAD and kind == "dead_row":  # the mean of V, lse -1e30
        v = qkv[..., 2 * h * d:].reshape(b, n, h, d)
        _close(out[:, DEAD].reshape(b, h, d), v.mean(1), QKV_FWD_TOL, "dead row")
        assert (lse[:, :, DEAD] == -1e30).all()
