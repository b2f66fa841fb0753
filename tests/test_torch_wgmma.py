"""The two kernels redesigned for Hopper's wgmma: the ViT GEMM (``vit_gemm``,
``csrc/vit_forward.cu``; behind K2v, K5a, K9, K2b, K2s and K10) and K6's
forward (``flash_qkv_fwd``, ``csrc/attention_wgmma.cuh``).

CPU tests: what surrounds the kernels is Python the CPU reaches. The GEMM's
wrapper casts an f32 A to bf16 and zero-pads A and W so that TMA can read
them (:func:`fused_dit_block.tma_operands`, inside
:func:`fused_dit_block.gemm_plan`): the padded product's first N columns
must equal :func:`fused_dit_block.linear_plain` on the unpadded operands
(f32 products of the same bf16 values; the zero columns add exact zeros, so
only BLAS blocking separates the two: atol 1e-5), and the plan must raise
on what the kernel does not take. K6's forward streams 64-key tiles:
:func:`flash_qkv_attention.flash_fwd_plain` at that tile against JAX's
``flash_qkv_attention`` in interpret mode, at N = 130 (a 2-key tail tile,
as ds3's 450 = 7 x 64 + 2) and 150, unmasked, layer-causal and with a
wholly masked row (forward and lse atol 2e-5: f32 both sides, summation
order only).

CUDA tests (marker ``cuda``; they skip without a card) hold each kernel
against its plain version on the same bf16 roundings, at small shapes that
reach its edges: ragged M, the K tail, the padded 90-wide operands, an odd
N, every epilogue with its ``save`` and the in-place gated residual for the
GEMM (``TOL["vit_gemm"]``'s 8e-3 of the scale: one bf16 rounding flip);
tails of the key and query tiles, odd and small head dims (the 4-byte copy
path), layer-causal and dead-row masks for K6 (2e-3, ``TOL["flash_qkv_fwd"]``).
On the card: ``python -m pytest --noconftest -m cuda tests/test_torch_wgmma.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:  # the JAX reference; the card's machine has no JAX and runs only `-m cuda`
    import jax.numpy as jnp

    from vit4hep_tpu.ops import flash_qkv_attention as jflash
except ModuleNotFoundError:
    jnp = None

from vit4hep_tpu_torch.ops import fused_dit_block as tfdb
from vit4hep_tpu_torch.ops import flash_qkv_attention as tflash
from vit4hep_tpu_torch.ops.pos_embed import layer_causal_mask

EPILOGUES = {"bias": tfdb.EPI_BIAS, "pos": tfdb.EPI_BIAS_POS, "gelu": tfdb.EPI_BIAS_GELU,
             "resid": tfdb.EPI_GATED_RESID}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: see README, 'PyTorch port')")
    return torch.device("cuda")


def _operands(m, k, n, n_tok, device="cpu", seed=0):
    """(a f32 (m, k), w bf16 (k, n), bias (n,), pos (n_tok, n), gate (m //
    n_tok, n) as a strided view of a (B, 3, n) panel, resid (m, n))."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=gen) * sc).to(device)  # noqa: E731
    gate = r(m // n_tok, 3, n)[:, 1]
    return (r(m, k), r(k, n, sc=0.1).to(torch.bfloat16), r(n, sc=0.1), r(n_tok, n), gate,
            r(m, n))


# ---------------------------------------------------------------------------
# the GEMM's operands and its plan (CPU)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n", [(90, 90, 480), (90, 480, 90), (30, 48, 480), (30, 480, 48),
                                   (30, 13, 7), (12, 480, 1440)])
def test_tma_operands_pad_without_changing_the_product(m, k, n):
    a, w, bias, *_ = _operands(m, k, n, 1, seed=m + k + n)
    a16, w16 = tfdb.tma_operands(a, w)
    k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
    assert a16.dtype == w16.dtype == torch.bfloat16
    assert tuple(a16.shape) == (m, k8) and tuple(w16.shape) == (k8, n8)
    assert a16.is_contiguous() and w16.is_contiguous()
    assert torch.equal(a16[:, :k], a.to(torch.bfloat16))  # round to nearest even, once
    assert torch.equal(w16[:k, :n], w)
    assert not a16[:, k:].any() and not w16[k:].any() and not w16[:, n:].any()
    got = (a16.float() @ w16.float())[:, :n] + bias
    torch.testing.assert_close(got, tfdb.linear_plain(a, w, bias, tfdb.EPI_BIAS),
                               atol=1e-5, rtol=0)
    if (k8, n8) == (k, n):  # nothing to pad: a bf16 A goes in as it is
        a_bf = a.to(torch.bfloat16)
        assert tfdb.tma_operands(a_bf, w)[0].data_ptr() == a_bf.data_ptr()


@pytest.mark.parametrize("epi", list(EPILOGUES))
def test_gemm_plan_prepares_every_epilogue(epi):
    m, k, n, n_tok = 30, 90, 90, 15
    a, w, bias, pos, gate, resid = _operands(m, k, n, n_tok, seed=3)
    out = torch.empty(m, n) if epi == "resid" else None
    save = torch.empty(m, n, dtype=torch.bfloat16) if epi in ("gelu", "resid") else None
    a16, w16, o, aux, aux_stride, res = tfdb.gemm_plan(
        "t", a, w, bias, EPILOGUES[epi], out, pos, gate, resid if epi == "resid" else None,
        save, n_tok)
    assert tuple(a16.shape) == (m, 96) and tuple(w16.shape) == (96, 96)
    assert tuple(o.shape) == (m, n)
    assert o.dtype == (torch.bfloat16 if epi == "gelu" else torch.float32)
    if epi == "resid":
        assert o is out and res is resid and aux is gate and aux_stride == 3 * n
    elif epi == "pos":
        assert aux is pos and res is None
    else:
        assert aux is None and res is None
    if epi == "resid":  # in place: the residual is the output unless given
        assert tfdb.gemm_plan("t", a, w, bias, EPILOGUES[epi], out, None, gate, None, None,
                              n_tok)[5] is out


def test_gemm_plan_raises_on_what_the_kernel_does_not_take():
    m, k, n, n_tok = 30, 48, 480, 15
    a, w, bias, pos, gate, resid = _operands(m, k, n, n_tok, seed=4)
    out = torch.empty(m, n)
    plan = lambda *args, **kw: tfdb.gemm_plan("t", *args, **kw)  # noqa: E731
    with pytest.raises(ValueError, match="multiple of n_tok"):
        plan(a, w, bias, tfdb.EPI_BIAS, None, None, None, None, None, 7)
    with pytest.raises(ValueError, match="chain"):
        plan(a[:, :40].contiguous(), w, bias, tfdb.EPI_BIAS, None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="A must be"):
        plan(a.half(), w, bias, tfdb.EPI_BIAS, None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="W must be"):
        plan(a, w.float(), bias, tfdb.EPI_BIAS, None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="pos"):
        plan(a, w, bias, tfdb.EPI_BIAS_POS, None, pos[:, :10], None, None, None, n_tok)
    with pytest.raises(ValueError, match="output buffer"):
        plan(a, w, bias, tfdb.EPI_GATED_RESID, None, None, gate, None, None, n_tok)
    with pytest.raises(ValueError, match="only the GELU"):
        plan(a, w, bias, tfdb.EPI_BIAS, None, None, None, None,
             torch.empty(m, n, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="unknown epilogue"):
        plan(a, w, bias, 7, None, None, None, None, None, 1)
    shifted = torch.empty(m * n + 1)[1:].view(m, n)  # 4 bytes off the float2 stores:
    assert plan(a, w, bias, tfdb.EPI_BIAS, shifted, None, None, None, None, 1)[2] is shifted
    a_off = torch.empty(m * k + 8, dtype=torch.bfloat16)[1:m * k + 1].view(m, k)
    with pytest.raises(ValueError, match="A is not 16-byte aligned"):
        plan(a_off, w, bias, tfdb.EPI_BIAS, None, None, None, None, None, 1)
    with pytest.raises(ValueError, match="CUDA"):  # the wrapper itself runs only on the card
        tfdb.linear(a, w, bias, tfdb.EPI_BIAS)
    assert plan(a, w, bias, tfdb.EPI_GATED_RESID, out, None, gate, resid, None, n_tok)[2] is out


# ---------------------------------------------------------------------------
# K6's forward at its key tiles (CPU, against JAX in interpret mode)
# ---------------------------------------------------------------------------
def _k6_mask(kind, n):
    if kind == "none":
        return None
    if kind == "layer_causal":
        return layer_causal_mask({130: (13, 2, 5), 150: (10, 3, 5)}[n])
    mask = np.tril(np.ones((n, n), bool))
    mask[n - 1] = False  # the last row, in the tail tile, attends to no key
    return mask


@pytest.mark.skipif(jnp is None, reason="needs JAX (the reference)")
@pytest.mark.parametrize("n", [130, 150])
@pytest.mark.parametrize("kind", ["none", "layer_causal", "dead_row"])
def test_flash_fwd_plain_at_the_kernel_tile_matches_jax(n, kind):
    b, h, d = 2, 2, 16
    qkv = np.random.default_rng(63 + n).normal(size=(b, n, 3 * h * d)).astype(np.float32)
    mask = _k6_mask(kind, n)
    out_j, res = jflash._flash_qkv_fwd(jnp.asarray(qkv), h, None if mask is None
                                       else jnp.asarray(mask), None, 128, 128)
    out, lse = tflash.flash_fwd_plain(torch.from_numpy(qkv), h, d ** -0.5,
                                      None if mask is None else torch.from_numpy(mask),
                                      block_k=tflash.TILE)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(res[3])[:, :n], atol=2e-5)
    if kind == "dead_row":  # the mean of V over the n real keys, not the padded tiles
        v = qkv[..., 2 * h * d:].reshape(b, n, h, d)
        np.testing.assert_allclose(out.numpy()[:, n - 1].reshape(b, h, d), v.mean(1), atol=2e-5)


@pytest.mark.parametrize("tool", ["kernels", "paths"])
def test_tree_comparison_tools_refuse_without_a_card(tool):
    """``tree_compare.py``, which times two trees on the card, exits 2 with
    no result where there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "tree_compare.py"), tool, "--tree",
                          str(root)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and run.stdout == "", (run.returncode, run.stdout, run.stderr)
    assert "no CUDA device" in run.stderr


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------
def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,n_tok", [(270, 48, 480, 135), (900, 90, 480, 450),
                                         (300, 480, 1440, 150), (257, 480, 90, 257),
                                         (200, 1920, 480, 100), (64, 40, 7, 1)])
@pytest.mark.parametrize("epi", list(EPILOGUES))
def test_vit_gemm_matches_plain_on_cuda(cuda_device, m, k, n, n_tok, epi):
    a, w, bias, pos, gate, resid = _operands(m, k, n, n_tok, cuda_device, seed=m + n)
    if epi != "pos":
        a = a.to(torch.bfloat16)  # the block products take bf16 A; the embedding f32
    e = EPILOGUES[epi]
    saves = [torch.empty(m, n, dtype=torch.bfloat16, device=cuda_device) for _ in range(2)] \
        if epi in ("gelu", "resid") else [None, None]
    outs = [resid.clone() for _ in range(2)] if epi == "resid" else [None, None]
    before = tfdb.TRAIN_GEMM.launches
    got = tfdb.train_linear(a, w, bias, e, out=outs[0], pos=pos, gate=gate, n_tok=n_tok,
                            save=saves[0])  # in place on the residual for "resid"
    torch.cuda.synchronize()
    assert tfdb.TRAIN_GEMM.launches == before + 1
    want = tfdb.linear_plain(a, w, bias, e, out=outs[1], pos=pos, gate=gate, n_tok=n_tok,
                             save=saves[1])
    _close(got, want, 8e-3)
    if saves[0] is not None:
        _close(saves[0], saves[1], 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("epi", ["bias", "gelu", "resid"])
def test_vit_gemm_stores_unaligned_buffers_on_cuda(cuda_device, epi):
    """An output, residual or save 4 (2) bytes off the pair stores' alignment
    is written one column at a time by the same kernel."""
    m, k, n, n_tok = 270, 480, 480, 135
    a, w, bias, pos, gate, resid = _operands(m, k, n, n_tok, cuda_device, seed=5)
    a = a.to(torch.bfloat16)
    e = EPILOGUES[epi]
    dt = torch.bfloat16 if epi == "gelu" else torch.float32
    off = lambda dtype: torch.empty(m * n + 1, dtype=dtype,  # noqa: E731
                                    device=cuda_device)[1:].view(m, n)
    out = off(dt)
    if epi == "resid":
        out.copy_(resid)
    save = off(torch.bfloat16) if epi != "bias" else None
    got = tfdb.train_linear(a, w, bias, e, out=out, gate=gate, n_tok=n_tok, save=save)
    assert got is out
    want_save = torch.empty(m, n, dtype=torch.bfloat16, device=cuda_device) \
        if save is not None else None
    want = tfdb.linear_plain(a, w, bias, e, out=resid.clone() if epi == "resid" else None,
                             gate=gate, n_tok=n_tok, save=want_save)
    _close(got, want, 8e-3)
    if save is not None:
        _close(save, want_save, 8e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,d", [(2, 6, 450, 80), (3, 2, 130, 80), (2, 3, 70, 13),
                                     (1, 4, 64, 128), (2, 1, 200, 6), (4, 6, 135, 80)])
@pytest.mark.parametrize("kind", ["none", "layer_causal", "dead_row"])
def test_flash_fwd_kernel_matches_plain_on_cuda(cuda_device, b, h, n, d, kind):
    gen = torch.Generator(device=cuda_device).manual_seed(64 + n)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda_device)
    if kind == "none":
        mask = None
    elif kind == "layer_causal" and n in (135, 450):
        mask = torch.from_numpy(layer_causal_mask({135: (15, 1, 9), 450: (15, 5, 6)}[n]))
    else:
        mask = torch.tril(torch.ones(n, n, dtype=torch.bool))
        if kind == "dead_row":
            mask[n - 1] = False
    mask = None if mask is None else mask.to(cuda_device)
    before = tflash.FWD.launches
    out, lse = tflash.flash_fwd_kernel(qkv, h, d ** -0.5, mask)
    torch.cuda.synchronize()
    assert tflash.FWD.launches == before + 1
    out_p, lse_p = tflash.flash_fwd_plain(qkv, h, d ** -0.5, mask, torch.bfloat16)
    _close(out, out_p, 2e-3)
    _close(lse, lse_p, 1e-4)
